"""Keyed op values — the ``independent/tuple`` MapEntry analog
(``independent.clj:20-28``). Lives in ops so both the checker layer and
the models can type-test keyed values without import cycles."""

from __future__ import annotations

from typing import Any


class KVTuple(tuple):
    """A (key, value) pair distinguishable from ordinary tuple values."""

    __slots__ = ()

    def __new__(cls, k, v):
        return tuple.__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]


def tuple_(k, v) -> KVTuple:
    return KVTuple(k, v)


def is_tuple(x: Any) -> bool:
    return isinstance(x, KVTuple)


def wrap_keyed_history(history):
    """Re-tag 2-element tuple values as :class:`KVTuple`. EDN histories
    (e.g. from the C register driver) carry ``[k v]`` vectors with no
    type marker; call this when a history is known to be keyed."""
    out = []
    for op in history:
        v = op.value
        if (isinstance(v, (tuple, list)) and len(v) == 2
                and not isinstance(v, KVTuple)):
            op = op.with_(value=KVTuple(v[0], v[1]))
        out.append(op)
    return out
