"""Packed struct-of-arrays history — the tensor form.

Every op becomes one row across parallel int arrays, with ``f`` and
``value`` interned into id tables (the tensor equivalent of
``knossos/model/memo.clj:40-59``'s ``canonical-history``). The checker
consumes this form; Op objects are only MATERIALIZED when an API edge
(counterexample decode, reports) asks for ``.ops``, which lazily
rebuilds the completed indexed list from the arrays.

The packer is :mod:`.columnar`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Hashable, List, Optional

import numpy as np

from ..obs import trace as _obs
from .op import Op, TYPE_NAMES


@dataclass
class PackedHistory:
    """A completed, indexed history as flat arrays.

    Attributes
    ----------
    process:    int32[n]  — interned process ids (see ``process_table``).
    type:       int8[n]   — 0 invoke / 1 ok / 2 fail / 3 info.
    f:          int32[n]  — interned f id.
    value:      int32[n]  — interned value id (whole value; tuple values
                             are interned as tuples).
    trans:      int32[n]  — interned (f, value) transition id for
                             invocations, -1 elsewhere (the tensor form of
                             ``memo.clj:131-142``'s transition-index).
    pair:       int32[n]  — index of the op's invocation/completion
                             partner, -1 for infos.
    fails:      bool[n]   — invocation will fail (skip in checkers).
    time:       int64[n]  — wall-clock nanos, -1 if unknown.
    *_table:    id → original object lookup lists.
    ops_list:   the completed indexed Op list, or None — materialized
                lazily via ``.ops`` (reporting only; the checkers never
                read it).
    """

    process: np.ndarray
    type: np.ndarray
    f: np.ndarray
    value: np.ndarray
    trans: np.ndarray
    pair: np.ndarray
    fails: np.ndarray
    time: np.ndarray
    process_table: List[Hashable]
    f_table: List[Hashable]
    value_table: List[Any]
    transition_table: List[tuple]  # (f_id, value_id) per transition id
    ops_list: Optional[List[Op]] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.process)

    @property
    def n_transitions(self) -> int:
        return len(self.transition_table)

    @property
    def ops(self) -> List[Op]:
        """The completed, indexed Op list — an API-edge VIEW rebuilt
        from the arrays on first access."""
        if self.ops_list is None:
            self.ops_list = _materialize_ops(self)
        return self.ops_list


def _materialize_ops(p: PackedHistory) -> List[Op]:
    out: List[Op] = []
    t = p.time.tolist()
    fl = p.fails.tolist()
    for i, (pc, tc, fc, vc) in enumerate(zip(
            p.process.tolist(), p.type.tolist(), p.f.tolist(),
            p.value.tolist())):
        out.append(Op(
            process=p.process_table[pc], type=TYPE_NAMES[tc],
            f=p.f_table[fc], value=p.value_table[vc], index=i,
            time=None if t[i] < 0 else t[i], fails=fl[i]))
    return out


@_obs.traced("ops.pack")
def pack_history(history: List[Op], completed: bool = False) -> PackedHistory:
    """Complete + index a history and pack it into arrays.

    Pass ``completed=True`` if the history already went through
    :func:`~.history.complete` and :func:`~.history.index`."""
    from .columnar import pack_history_columnar

    return pack_history_columnar(history, completed=completed)
