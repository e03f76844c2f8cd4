"""Sets workload as per-element bitmap membership algebra.

The Jepsen set test adds elements and reads the whole set back once at
the end; the verdict is pure set algebra over three populations
(``checker.clj:108-154``, :class:`~..checkers.SetChecker`):

- lost       = acked adds the final read never returned
- unexpected = read-back elements nobody ever attempted (phantoms)
- recovered  = attempted-not-acked adds that surfaced anyway (legal)

On device each history lane is three element bitmaps over a
host-interned id space (first-occurrence order, exactly like the
packer's value tables): ``attempts`` / ``adds`` / ``final_read``
bool[B, E]. The whole batch verdict is a handful of masked
reductions — no frontier, no sort — as one device call of torch ops
(the counterpart of the JAX package's ``checker/wl/sets.py``). ``E``
comes from the ``WL_ELEMS`` ladder.

A history with no ok read answers UNKNOWN ("Set was never read") on
the host side, mirroring the oracle — its lane still rides the
device call (masked out) so the batch stays one call.

Not ported yet: the stream rungs' delta forms (``wl_sets_delta``,
``wl_sets_delta_mb``); they go with streaming.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

#: fields of :class:`SetsColumns` that :func:`wl_sets_check` takes, in
#: its argument order
DEVICE_FIELDS = ("attempts", "adds", "final_read", "has_read")


class SetsColumns(NamedTuple):
    attempts: np.ndarray    # bool[B, E]
    adds: np.ndarray        # bool[B, E]
    final_read: np.ndarray  # bool[B, E]
    has_read: np.ndarray    # bool[B]
    tables: tuple           # per-lane id -> element value


def encode_sets(histories: Sequence[Sequence], *,
                e_pad: int) -> SetsColumns:
    """Host encode: intern each lane's element values (adds AND read
    contents — a phantom element appears only in the read) in
    first-occurrence order, then set bitmap bits."""
    B = len(histories)
    attempts = np.zeros((B, e_pad), bool)
    adds = np.zeros((B, e_pad), bool)
    final_read = np.zeros((B, e_pad), bool)
    has_read = np.zeros(B, bool)
    tables = []
    for b, hist in enumerate(histories):
        ids: dict = {}

        def eid(v):
            i = ids.get(v)
            if i is None:
                i = ids[v] = len(ids)
                if i >= e_pad:
                    raise ValueError(
                        f"history {b}: > {e_pad} distinct elements")
            return i

        last_read = None
        for op in hist:
            if op.f == "add" and op.value is not None:
                i = eid(op.value)
                if op.type == "invoke":
                    attempts[b, i] = True
                elif op.type == "ok":
                    # an acked add is by definition attempted, even in
                    # completion-only histories with no invoke events
                    attempts[b, i] = True
                    adds[b, i] = True
            elif (op.f == "read" and op.type == "ok"
                    and op.value is not None):
                last_read = op.value
        if last_read is not None:
            has_read[b] = True
            for v in last_read:
                final_read[b, eid(v)] = True
        tables.append(tuple(ids))
    return SetsColumns(attempts, adds, final_read, has_read,
                       tuple(tables))


def wl_sets_check(attempts, adds, final_read, has_read, *,
                  n_elems: int):
    """One batched sets verdict over bool[B, E] membership planes on
    one device (the torch counterpart of the JAX package's jit)."""
    if attempts.shape[1] != n_elems:
        raise ValueError(f"sets planes {tuple(attempts.shape)} are not "
                         f"the declared width {n_elems}")
    ok = final_read & attempts
    unexpected = final_read & ~attempts
    lost = adds & ~final_read
    recovered = ok & ~adds
    valid = has_read & ~(lost | unexpected).any(1)
    return (valid, ok, lost, unexpected, recovered)


def sets_verdicts(cols: SetsColumns, out) -> List[dict]:
    """Decode to the oracle's result shape — same interval-set strings
    and fractions as :class:`~..checkers.SetChecker`, bit-identical on
    every lane."""
    from ...utils.intervals import fraction, integer_interval_set_str
    from ..checkers import UNKNOWN

    valid, ok, lost, unexpected, recovered = \
        (np.asarray(x) for x in out)
    verdicts = []
    for b, table in enumerate(cols.tables):
        if not cols.has_read[b]:
            verdicts.append({"valid?": UNKNOWN,
                             "error": "Set was never read"})
            continue
        dec = lambda plane: {table[i] for i in np.flatnonzero(plane[b])}
        n_att = int(np.count_nonzero(cols.attempts[b]))
        sets = {k: dec(p) for k, p in
                (("ok", ok), ("lost", lost),
                 ("unexpected", unexpected), ("recovered", recovered))}
        v = {"valid?": bool(valid[b])}
        for k, s in sets.items():
            v[k] = integer_interval_set_str(s)
            v[f"{k}-frac"] = fraction(len(s), n_att)
        # match the oracle's key order/shape exactly
        verdicts.append({"valid?": v["valid?"],
                         "ok": v["ok"], "lost": v["lost"],
                         "unexpected": v["unexpected"],
                         "recovered": v["recovered"],
                         "ok-frac": v["ok-frac"],
                         "unexpected-frac": v["unexpected-frac"],
                         "lost-frac": v["lost-frac"],
                         "recovered-frac": v["recovered-frac"]})
    return verdicts


__all__ = ["DEVICE_FIELDS", "SetsColumns", "encode_sets",
           "sets_verdicts", "wl_sets_check"]
