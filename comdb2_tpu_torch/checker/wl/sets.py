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

The stream rung's delta forms (``wl_sets_delta``, ``wl_sets_delta_mb``)
advance a live session's three (E,) membership planes by one append;
the solo form is the lane-batched body at B = 1, so a megabatched
advance is bit-identical to the solo one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

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


def _sets_delta_lanes(attempts, adds, final_read, attempts_d, adds_d,
                      read_d, has_read_d, has_read):
    """B lanes' sets deltas against their bitmap-plane carries (all
    planes (B, E), flags (B,)): the one body of the solo and the
    megabatched form. ``has_read_d`` (this delta read) and
    ``has_read`` (union INCLUDING this delta) are host-computed — an
    empty-set read is still a read, so presence can't be inferred from
    ``read_d``. A read REPLACES ``final_read`` (last-read-wins, as the
    one-shot encoder), which is why the sets verdict is only
    provisional until close."""
    att = attempts | attempts_d
    add = adds | adds_d
    fr = torch.where(has_read_d[:, None], read_d, final_read)
    lost = add & ~fr
    unexpected = fr & ~att
    valid_now = has_read & ~(lost | unexpected).any(1)
    return (att, add, fr, valid_now, lost.sum(1, dtype=torch.int32),
            unexpected.sum(1, dtype=torch.int32))


def _flag(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.bool, device=device).reshape(-1)


def wl_sets_delta(attempts, adds, final_read, attempts_d, adds_d,
                  read_d, has_read_d, has_read, *, n_elems: int):
    """Stream-rung solo advance, O(delta): the carry is the three (E,)
    membership planes at the session's ``WL_ELEMS`` rung (tensors on
    one device). Returns ``(attempts, adds, final_read, valid_now,
    n_lost, n_unexpected)`` on the device."""
    if tuple(attempts.shape) != (n_elems,):
        raise ValueError(f"sets planes {tuple(attempts.shape)} are not "
                         f"the declared width {n_elems}")
    dev = attempts.device
    out = _sets_delta_lanes(attempts[None], adds[None], final_read[None],
                            attempts_d[None], adds_d[None], read_d[None],
                            _flag(has_read_d, dev), _flag(has_read, dev))
    return tuple(o[0] for o in out)


def wl_sets_delta_mb(carries, attempts_d, adds_d, read_d, has_read_d,
                     has_read, *, n_elems: int):
    """Megabatched advance: ``carries`` is a TUPLE of per-lane
    ``(attempts, adds, final_read)`` tensor triples; the delta planes
    carry a lane axis. One batched pass of the solo form's body —
    bit-identical per lane. Returns one output tuple per lane."""
    att = torch.stack([c[0] for c in carries])
    add = torch.stack([c[1] for c in carries])
    fr = torch.stack([c[2] for c in carries])
    if tuple(att.shape) != (len(carries), n_elems):
        raise ValueError(f"sets planes {tuple(att.shape)} are not the "
                         f"declared width {n_elems}")
    dev = att.device
    outs = _sets_delta_lanes(att, add, fr, attempts_d, adds_d, read_d,
                             _flag(has_read_d, dev), _flag(has_read, dev))
    return tuple(tuple(o[i] for o in outs)
                 for i in range(len(carries)))


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
           "sets_verdicts", "wl_sets_check", "wl_sets_delta",
           "wl_sets_delta_mb"]
