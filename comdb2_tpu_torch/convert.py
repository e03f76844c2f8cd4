"""Carry the JAX package's host arrays into the port's tensors.

The counterpart of carrying weights across: a memoized successor
table, a segment stream, a kernel frontier, a txn dependency graph and
a workload family's encoded columns made by the JAX package (or
anything shaped like them — duck typing, no import of that package)
become the port's objects on a given device, so one set of numpy
inputs can be fed to both packages and their outputs compared.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .checker.linear_torch import SegmentStream
from .checker.wl import bank as _bank
from .checker.wl import dirty as _dirty
from .checker.wl import sets as _sets
from .utils import resolve_device


def succ_tensor(succ, device=None) -> torch.Tensor:
    """int32[n_states, n_transitions] successor table on ``device``;
    ``succ`` is an array or anything with a ``.succ`` (a
    ``MemoizedModel``)."""
    arr = np.asarray(getattr(succ, "succ", succ), np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device))


class SegmentTensors(NamedTuple):
    """A segment stream's five fields as tensors."""
    inv_proc: torch.Tensor   # int32[S, K]
    inv_tr: torch.Tensor     # int32[S, K]
    ok_proc: torch.Tensor    # int32[S]
    seg_index: torch.Tensor  # int64[S]
    depth: torch.Tensor      # int32[S]


def segment_stream(segs) -> SegmentStream:
    """The port's host :class:`SegmentStream` from any object with the
    five fields (copies, so the two packages share no buffer)."""
    return SegmentStream(
        np.array(segs.inv_proc, np.int32), np.array(segs.inv_tr, np.int32),
        np.array(segs.ok_proc, np.int32), np.array(segs.seg_index, np.int64),
        np.array(segs.depth, np.int32))


def segment_tensors(segs, device=None) -> SegmentTensors:
    """A segment stream's five numpy fields as tensors on ``device``."""
    s = segment_stream(segs)
    dev = resolve_device(device)
    return SegmentTensors(*(torch.from_numpy(a).to(dev) for a in s))


def frontier_words(ws, device=None) -> torch.Tensor:
    """A kernel frontier word list — the JAX kernel's ``ws`` from
    ``return_boundary``: ``n_words`` arrays of (rows, 128), least
    significant word first, the frontier in row 0 — as the port's
    int32[n_words, 128] frontier tensor. 1-D words (already one row)
    pass through."""
    rows = [np.asarray(w, np.int32) for w in ws]
    rows = [w[0] if w.ndim == 2 else w for w in rows]
    return torch.from_numpy(np.stack(rows)).to(resolve_device(device))


def txn_planes(graph_or_adj, device=None) -> torch.Tensor:
    """A txn dependency graph's (4, N, N) ww / wr / rw / rt planes as a
    bool tensor on ``device``: ``graph_or_adj`` is anything with an
    ``.adj`` (a ``TxnGraph`` of either package) or the adjacency array
    itself (a ``TxnGraph.padded()``); a leading batch axis passes
    through."""
    adj = np.asarray(getattr(graph_or_adj, "adj", graph_or_adj), bool)
    return torch.from_numpy(np.ascontiguousarray(adj)).to(
        resolve_device(device))


#: per workload family, a field only its columns have and the device
#: planes its ``wl_*_check`` takes, in argument order
_WL_FIELDS = (("transfers", _bank.DEVICE_FIELDS),
              ("attempts", _sets.DEVICE_FIELDS),
              ("failed", _dirty.DEVICE_FIELDS))


def wl_columns(cols, device=None) -> tuple:
    """A workload family's encoded columns — ``BankColumns``,
    ``SetsColumns`` or ``DirtyColumns`` of either package — as the
    tensors its ``wl_*_check`` takes, in argument order, on
    ``device``."""
    dev = resolve_device(device)
    for marker, fields in _WL_FIELDS:
        if hasattr(cols, marker):
            return tuple(torch.from_numpy(np.ascontiguousarray(
                getattr(cols, f))).to(dev) for f in fields)
    raise TypeError(f"not a workload family's columns: {type(cols)!r}")
