"""Segment stream and shared constants of the device search.

The counterpart of the JAX package's ``checker/linear_jax.py``. This
module holds its host half: the status and slot constants, the
per-ok segment stream (:func:`make_segments`), slot renaming
(:func:`remap_slots`), successor-table padding and the search-cost
estimate. The engines that consume a :class:`SegmentStream` live in
:mod:`.seg_kernel`.
"""

from __future__ import annotations

import heapq
import math
from typing import NamedTuple, Optional

import numpy as np

IDLE = -1
LIN = -2

# result status codes
VALID = 0
INVALID = 1
UNKNOWN = 2    # frontier overflow


def estimated_cost(pending_counts) -> float:
    """Σ n·n! over configs — the reference's search-cost estimate by
    pending-call count (``knossos/linear/config.clj:374-393``): each
    config with n pending calls can spawn up to n·Γ(n+1) orders."""
    return float(sum(n * math.factorial(min(int(n), 12))
                     for n in pending_counts))


def pad_succ(succ: np.ndarray, s_pad: Optional[int] = None,
             t_pad: Optional[int] = None) -> np.ndarray:
    """Pad the successor table to bucketed shapes. Padding states and
    transitions are all-inconsistent (-1)."""
    S, T = succ.shape
    s_pad, t_pad = s_pad or S, t_pad or T
    out = np.full((s_pad, t_pad), -1, np.int32)
    out[:S, :T] = succ
    return out


class SegmentStream(NamedTuple):
    """Host-precompiled segments (see :func:`make_segments`): segment i
    carries the invokes since the previous ok (padded to K) plus the
    ok's process. ``seg_index`` maps segment → history index of its ok
    (for decoding fail_at). ``depth`` is the number of pending calls at
    the ok — the exact closure-iteration bound (a linearization chain
    can't be longer than the pending set)."""
    inv_proc: np.ndarray   # int32[S, K], -1 padding
    inv_tr: np.ndarray     # int32[S, K]
    ok_proc: np.ndarray    # int32[S]
    seg_index: np.ndarray  # int64[S]
    depth: np.ndarray      # int32[S]


def make_segments(packed, s_pad: Optional[int] = None,
                  k_pad: Optional[int] = None) -> SegmentStream:
    """Compress a history into per-ok segments.

    Only ok-ops change the frontier's validity — invokes just set a
    slot, and fail/info rows are no-ops (``linear.clj:226``). Folding
    each run of invokes into its following ok yields one device step
    per ok-op. Invokes after the final ok are dropped: a pending call
    can only *add* linearization orders, never empty a non-empty
    frontier.

    Columnar: one stable argsort for the per-process pending-discipline
    check, cumsums for depths, one scatter for the (S, K) fill. Pads
    are floors — the actual maxima still win."""
    from ..ops.columnar import _per_process_prev
    from ..ops.op import FAIL, INVOKE, OK

    t = np.asarray(packed.type)
    proc = np.asarray(packed.process)
    tra = np.asarray(packed.trans)
    fl = np.asarray(packed.fails)
    n = t.shape[0]
    vinv = (t == INVOKE) & ~fl
    okm = t == OK
    failm = t == FAIL
    removal = np.zeros(n, bool)
    sel = np.flatnonzero(vinv | okm | failm)
    if sel.size:
        # per-process event chains: pending_p is {0,1} (add on a
        # non-failing invoke, clear on ok/fail), so "p was pending" ==
        # "p's previous selected event was a non-failing invoke"
        srt, vflag, prev_v, _ = _per_process_prev(proc, sel, vinv)
        dbl = vflag & prev_v
        if dbl.any():
            i = int(srt[dbl].min())
            raise ValueError(
                f"process {int(proc[i])} invokes at row {i} while an "
                "earlier invocation is still pending — malformed "
                "history")
        removal[srt[~vflag & prev_v]] = True
    ok_idx = np.flatnonzero(okm)
    S = ok_idx.size
    cum_rem = np.cumsum(removal)
    depth_vals = (np.cumsum(vinv)[ok_idx]
                  - (cum_rem[ok_idx] - removal[ok_idx]))
    cum_ok_excl = np.cumsum(okm) - okm
    inv_rows = np.flatnonzero(vinv)
    seg_of = cum_ok_excl[inv_rows]
    keep = seg_of < S              # invokes after the final ok drop
    inv_rows, seg_of = inv_rows[keep], seg_of[keep]
    if inv_rows.size:
        kpos = (np.arange(inv_rows.size)
                - np.searchsorted(seg_of, seg_of, side="left"))
        K = int(np.bincount(seg_of).max()) or 1
    else:
        kpos = seg_of
        K = 1
    k_pad = max(k_pad or 0, K)
    s_pad = max(s_pad or 0, S)
    inv_proc = np.full((s_pad, k_pad), -1, np.int32)
    inv_tr = np.zeros((s_pad, k_pad), np.int32)
    inv_proc[seg_of, kpos] = proc[inv_rows]
    inv_tr[seg_of, kpos] = tra[inv_rows]
    ok_proc = np.full(s_pad, -1, np.int32)   # -1 = padding segment
    seg_index = np.zeros(s_pad, np.int64)
    depth = np.zeros(s_pad, np.int32)
    ok_proc[:S] = proc[ok_idx]
    seg_index[:S] = ok_idx
    depth[:S] = depth_vals
    return SegmentStream(inv_proc, inv_tr, ok_proc, seg_index, depth)


def remap_slots(segs: SegmentStream, with_maps: bool = False):
    """Rename process ids in a segment stream to a minimal pool of
    reusable SLOTS. A process occupies a slot only while its call is
    open (invoke .. ok); the assignment is determined by the history
    alone — identical for every config — so renaming is a pure
    relabeling: verdicts, fail segments, and frontier sizes are
    unchanged. The effective slot count becomes the maximum number of
    CONCURRENT open calls, not the process count, which is what gates
    the kernel's tiers (:func:`.seg_kernel.spec_for`). Reuse is safe
    because an ok'd slot is IDLE in every surviving config before the
    stream can reassign it.

    Allocation is lowest-free-first within each segment's invoke list,
    releases happen after the segment's ok — so a slot freed by segment
    s is reusable from segment s+1 on. :info invokes never complete and
    hold their slot for the rest of the stream.

    Returns ``(segs', P_eff)``, plus ``proc_of_slot`` (int32[S, P_eff];
    row s = which ORIGINAL process owns each slot after segment s, -1
    when free) when ``with_maps`` — the inverse needed to decode a
    device frontier back into process-indexed configs
    (:func:`.counterexample.reconstruct`).
    """
    S, K = segs.inv_proc.shape
    ip = segs.inv_proc.tolist()
    okl = segs.ok_proc.tolist()
    out_ip = [row[:] for row in ip]
    out_ok = list(okl)
    slot_of: dict = {}
    free: list = []
    n_slots = 0
    maps = [] if with_maps else None
    owners: list = []
    for s in range(S):
        row = ip[s]
        orow = out_ip[s]
        for k in range(K):
            p = row[k]
            if p < 0:
                continue
            if p in slot_of:
                raise ValueError(
                    f"process {p} invokes in segment {s} while an "
                    "earlier invocation is still open")
            if free:
                sl = heapq.heappop(free)
            else:
                sl = n_slots
                n_slots += 1
                owners.append(-1)
            slot_of[p] = sl
            owners[sl] = p
            orow[k] = sl
        o = okl[s]
        if o >= 0:
            sl = slot_of.pop(o, None)
            if sl is None:
                # ok without an open invocation: the process's slot is
                # IDLE in every config, so the ok filter empties the
                # frontier (INVALID at this segment). Any free slot is
                # IDLE everywhere too — map to one to preserve exactly
                # that instead of rejecting the stream.
                if free:
                    out_ok[s] = free[0]
                else:
                    out_ok[s] = n_slots
                    n_slots += 1
                    owners.append(-1)
                    heapq.heappush(free, out_ok[s])
            else:
                out_ok[s] = sl
                owners[sl] = -1
                heapq.heappush(free, sl)
        if with_maps:
            maps.append(owners[:])
    P_eff = n_slots
    segs2 = SegmentStream(
        np.asarray(out_ip, np.int32).reshape(S, K),
        segs.inv_tr, np.asarray(out_ok, np.int32),
        segs.seg_index, segs.depth)
    if with_maps:
        pos = np.full((S, max(P_eff, 1)), -1, np.int32)
        for s, row in enumerate(maps):
            if row:
                pos[s, :len(row)] = row
        return segs2, P_eff, pos
    return segs2, P_eff
