"""Dirty-reads workload as a failed-write visibility join.

The comdb2 dirty-reads test writes values (some of which FAIL) and
reads the row back from every node at once; a failed write's value
must never become visible to any read, and the per-node views of one
read should agree (``comdb2/core.clj:492-523``,
:class:`~..workloads.DirtyReadsChecker`).

On device (one call of torch ops, the counterpart of the JAX package's
``checker/wl/dirty.py``) the join is a gather: failed-write values intern into a
per-lane id table, the ``failed`` visibility plane is bool[B, V], and
each read row is its per-node value ids int32[B, R, N]; a read is
dirty when any valid node id gathers True from the failed plane. The
per-node-DISAGREEMENT check (masked min != max over node ids) rides
the same call — like the oracle's ``inconsistent-reads`` it is
diagnostic only, so ``valid?`` stays bit-identical to the (fixed)
host oracle.

Malformed read values — a scalar or a ``str`` where a per-node
sequence belongs — are rejected at encode time with the same
``malformed-reads`` cause the hardened oracle reports; the lane
answers UNKNOWN, never a silently per-character-iterated verdict.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..workloads import freeze_value
from .bank import first_true

#: fields of :class:`DirtyColumns` that :func:`wl_dirty_check` takes, in
#: its argument order
DEVICE_FIELDS = ("failed", "reads", "node_mask", "read_mask")


class DirtyColumns(NamedTuple):
    failed: np.ndarray      # bool[B, V]
    reads: np.ndarray       # int32[B, R, N] value ids (0 where masked)
    node_mask: np.ndarray   # bool[B, R, N]
    read_mask: np.ndarray   # bool[B, R]
    read_index: np.ndarray  # int32[B, R] — op index of each read row
    tables: tuple           # per-lane id -> value
    malformed: tuple        # per-lane list of offending op indices


def is_malformed_read(v) -> bool:
    """A read value must be a per-node sequence: a ``str`` silently
    iterates per character and a scalar raises — both are client bugs
    the checker must name, not absorb."""
    return isinstance(v, (str, bytes)) or not isinstance(v, (list,
                                                             tuple))


def encode_dirty(histories: Sequence[Sequence], *, r_pad: int,
                 n_pad: int, v_pad: int) -> DirtyColumns:
    """Host encode: intern failed-write values and read elements into
    one per-lane table (first-occurrence order); malformed reads mark
    the lane instead of joining the planes."""
    B = len(histories)
    failed = np.zeros((B, v_pad), bool)
    reads = np.zeros((B, r_pad, n_pad), np.int32)
    node_mask = np.zeros((B, r_pad, n_pad), bool)
    read_mask = np.zeros((B, r_pad), bool)
    read_index = np.full((B, r_pad), -1, np.int32)
    tables = []
    malformed = []
    for b, hist in enumerate(histories):
        ids: dict = {}

        def eid(v):
            v = freeze_value(v)
            i = ids.get(v)
            if i is None:
                i = ids[v] = len(ids)
                if i >= v_pad:
                    raise ValueError(
                        f"history {b}: > {v_pad} distinct values")
            return i

        bad_ops = []
        r = 0
        for i, op in enumerate(hist):
            if op.f == "write" and op.type == "fail" \
                    and op.value is not None:
                failed[b, eid(op.value)] = True
            elif (op.f == "read" and op.type == "ok"
                    and op.value is not None):
                if is_malformed_read(op.value):
                    bad_ops.append(i if op.index is None else op.index)
                    continue
                if len(op.value) > n_pad:
                    raise ValueError(
                        f"history {b}: read of > {n_pad} node views")
                if r >= r_pad:
                    raise ValueError(f"history {b}: > {r_pad} reads")
                read_mask[b, r] = True
                read_index[b, r] = i if op.index is None else op.index
                for j, x in enumerate(op.value):
                    reads[b, r, j] = eid(x)
                    node_mask[b, r, j] = True
                r += 1
        tables.append(tuple(ids))
        malformed.append(tuple(bad_ops))
    return DirtyColumns(failed, reads, node_mask, read_mask,
                        read_index, tuple(tables), tuple(malformed))


def wl_dirty_check(failed, reads, node_mask, read_mask, *,
                   n_reads: int, n_nodes: int, n_values: int):
    """One batched dirty-reads verdict on one device (the torch
    counterpart of the JAX package's jit): visibility join + per-node
    disagreement. Masked node slots hold id 0, a valid column."""
    B = reads.shape[0]
    if tuple(reads.shape) != (B, n_reads, n_nodes) \
            or tuple(failed.shape) != (B, n_values):
        raise ValueError(f"dirty planes {tuple(reads.shape)} / "
                         f"{tuple(failed.shape)} are not the declared "
                         f"({n_reads}, {n_nodes}, {n_values})")
    flat = reads.reshape(B, n_reads * n_nodes).long()
    hit = torch.gather(failed, 1, flat) \
        .reshape(B, n_reads, n_nodes) & node_mask
    dirty = hit.any(2) & read_mask                           # (B,R)
    big = torch.where(node_mask, reads, -(1 << 30))
    small = torch.where(node_mask, reads, 1 << 30)
    disagree = (big.amax(2) != small.amin(2)) & read_mask
    return (~dirty.any(1), dirty, disagree, first_true(dirty))


def dirty_verdicts(cols: DirtyColumns, out) -> List[dict]:
    """Decode to the oracle's shape: ``dirty-reads`` /
    ``inconsistent-reads`` carry the offending READ VALUES (decoded
    through the lane's table), malformed lanes answer UNKNOWN with
    the op indices."""
    from ..checkers import UNKNOWN

    valid, dirty, disagree, first_bad = (np.asarray(x) for x in out)
    verdicts = []
    for b, table in enumerate(cols.tables):
        def row(r):
            return tuple(table[cols.reads[b, r, j]]
                         for j in np.flatnonzero(cols.node_mask[b, r]))

        filthy = [row(r) for r in np.flatnonzero(dirty[b])]
        inconsistent = [row(r) for r in np.flatnonzero(disagree[b])]
        v = {"valid?": bool(valid[b]),
             "inconsistent-reads": inconsistent,
             "dirty-reads": filthy,
             "first-bad-read": int(first_bad[b])}
        if cols.malformed[b]:
            v["valid?"] = UNKNOWN
            v["malformed-reads"] = list(cols.malformed[b])
        verdicts.append(v)
    return verdicts


__all__ = ["DEVICE_FIELDS", "DirtyColumns", "dirty_verdicts",
           "encode_dirty", "is_malformed_read", "wl_dirty_check"]
