"""Operations.

An operation is the atom of a history. Mirrors the reference's
``knossos/op.clj:9-60``: an op has a ``process`` (a logical
single-threaded client, or a symbolic actor like ``"nemesis"``), a
``type`` (invoke / ok / fail / info), a function ``f``, a ``value``, and —
once indexed — an ``index`` into its history. ``time`` is wall-clock
nanoseconds relative to test start.

We keep ops as a small mutable dataclass on the host; the checker consumes
the packed tensor form (see ``comdb2_tpu_torch.ops.packed``), never these
objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Hashable, Optional

# Op types. Integer codes are the on-tensor encoding.
INVOKE = 0
OK = 1
FAIL = 2
INFO = 3

TYPE_NAMES = ("invoke", "ok", "fail", "info")
TYPE_CODES = {name: code for code, name in enumerate(TYPE_NAMES)}


@dataclass
class Op:
    """One operation in a history.

    ``type`` is one of the string names in :data:`TYPE_NAMES`. ``fails``
    is back-filled by :func:`comdb2_tpu_torch.ops.history.complete` on
    invocations whose completion is a ``fail`` — checkers skip those
    (reference: ``knossos/history.clj:165``).
    """

    process: Hashable
    type: str
    f: Hashable
    value: Any = None
    index: Optional[int] = None
    time: Optional[int] = None
    fails: bool = False
    extra: dict = field(default_factory=dict)

    def with_(self, **kw) -> "Op":
        # hand-rolled replace(): the dataclasses version re-runs
        # __init__ with type checks and dominates host-side history
        # packing (millions of calls on the 4096-history batch axis)
        bad = kw.keys() - self.__dict__.keys()
        if bad:     # replace() raised on unknown fields; keep that
            raise TypeError(f"unknown Op field(s): {sorted(bad)}")
        new = Op.__new__(Op)
        new.__dict__ = {**self.__dict__, **kw}
        return new

    @property
    def type_code(self) -> int:
        return TYPE_CODES[self.type]

    def to_map(self) -> dict:
        """As an EDN-style keyword map (for history files)."""
        from .edn import kw

        m = {
            kw("process"): self.process,
            kw("type"): kw(self.type),
            kw("f"): kw(self.f) if isinstance(self.f, str) else self.f,
            kw("value"): self.value,
        }
        if self.index is not None:
            m[kw("index")] = self.index
        if self.time is not None:
            m[kw("time")] = self.time
        return m


def invoke(process, f, value=None, **kw) -> Op:
    return Op(process, "invoke", f, value, **kw)


def ok(process, f, value=None, **kw) -> Op:
    return Op(process, "ok", f, value, **kw)


def fail(process, f, value=None, **kw) -> Op:
    return Op(process, "fail", f, value, **kw)


def info(process, f, value=None, **kw) -> Op:
    return Op(process, "info", f, value, **kw)


def is_invoke(op: Op) -> bool:
    return op.type == "invoke"


def is_ok(op: Op) -> bool:
    return op.type == "ok"


def is_fail(op: Op) -> bool:
    return op.type == "fail"


def is_info(op: Op) -> bool:
    return op.type == "info"
