"""Segment stream, packing plans and the torch-op search engines.

The counterpart of the JAX package's ``checker/linear_jax.py``:

- the host half: status and slot constants, the per-ok segment stream
  (:func:`make_segments`), slot renaming (:func:`remap_slots`,
  :func:`remap_slots_batch`), successor-table padding, the search-cost
  estimates and the lossless multi-word :class:`PackPlan`;
- the seg2 capacity engine (:func:`check_device_seg2`,
  :func:`check_device_seg2_chunk`): the escalation ladder behind the
  segment-search kernel, one history, frontier ``(states, slots,
  valid)`` of capacity F with the Fs=32 small tier;
- the keys engine (:func:`check_device_keys`): B histories, frontier
  as ``(hi, lo)`` int32 key pairs, one per-block pair sort per closure
  iteration (:mod:`.pair_sort`, a CUDA kernel on the card);
- the per-op engine (:func:`check_device`, one step per op) and the
  big-only segmented engine (:func:`check_device_seg`,
  :func:`check_device_seg_chunk`), with their batched forms
  (:func:`check_device_batch`, :func:`check_device_seg_batch`: the JAX
  package's ``vmap``, one computation over B lanes whose closures each
  stop at their own fixed point);
- the flat engine (:func:`check_device_flat`): B histories in one
  explicit frontier tensor, the batch id the top field of a two-word
  sort key, the closure in lockstep.

XLA ran the engines outside any Pallas kernel, so here they are torch
ops on the inputs' device: ``jnp.lexsort`` becomes successive stable
sorts, least significant key first; ``.at[t].set(mode="drop")`` a
scatter into one extra drop row that is sliced off; ``lax.scan`` a
host loop over segments (or ops) and ``lax.while_loop`` a loop bounded
by ``depth``. Each closure iteration reads one flag back to the host.
The segment-search kernel itself lives in :mod:`.seg_kernel`.
"""

from __future__ import annotations

import functools
import heapq
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

IDLE = -1
LIN = -2

# op kinds in the per-op step stream
K_SKIP = 0     # fail/info completions, failing invokes, padding
K_INVOKE = 1
K_OK = 2

# result status codes
VALID = 0
INVALID = 1
UNKNOWN = 2    # frontier overflow


class StepStream(NamedTuple):
    """Per-op step metadata (see :func:`make_stream`)."""
    kind: np.ndarray   # int32[n]
    proc: np.ndarray   # int32[n]
    tr: np.ndarray     # int32[n]


def make_stream(packed, n_pad: Optional[int] = None) -> StepStream:
    """A PackedHistory as the per-op step stream, padded with no-op
    steps to ``n_pad``: non-failing invokes carry (process, transition),
    oks their process."""
    from ..ops.op import INVOKE, OK

    n = len(packed)
    n_pad = n_pad or n
    t = np.asarray(packed.type)
    inv = (t == INVOKE) & ~np.asarray(packed.fails, bool)
    ok = t == OK
    kind = np.zeros(n_pad, np.int32)
    proc = np.zeros(n_pad, np.int32)
    tr = np.zeros(n_pad, np.int32)
    kind[:n][inv] = K_INVOKE
    kind[:n][ok] = K_OK
    proc[:n] = np.where(inv | ok, np.asarray(packed.process), 0)
    tr[:n] = np.where(inv, np.asarray(packed.trans), 0)
    return StepStream(kind, proc, tr)


def estimated_cost(pending_counts) -> float:
    """Σ n·n! over configs — the reference's search-cost estimate by
    pending-call count (``knossos/linear/config.clj:374-393``): each
    config with n pending calls can spawn up to n·Γ(n+1) orders."""
    return float(sum(n * math.factorial(min(int(n), 12))
                     for n in pending_counts))


def estimated_cost_hist(hist) -> float:
    """:func:`estimated_cost` from a pending-count histogram
    (``hist[k]`` = configs with k pending calls)."""
    return float(sum(int(c) * k * math.factorial(min(k, 12))
                     for k, c in enumerate(hist)))


def pending_histogram(slots: torch.Tensor, valid: torch.Tensor, *,
                      P: int) -> torch.Tensor:
    """Per-config pending-call counts bucketed on the device: progress
    telemetry reads back P+1 ints, not the (F, P) frontier."""
    pend = (slots >= 0).sum(dim=1)
    return torch.bincount(pend, weights=valid.to(torch.float64),
                          minlength=P + 1)[:P + 1].to(torch.int64)


def pad_succ(succ: np.ndarray, s_pad: Optional[int] = None,
             t_pad: Optional[int] = None) -> np.ndarray:
    """Pad the successor table to bucketed shapes. Padding states and
    transitions are all-inconsistent (-1)."""
    S, T = succ.shape
    s_pad, t_pad = s_pad or S, t_pad or T
    out = np.full((s_pad, t_pad), -1, np.int32)
    out[:S, :T] = succ
    return out


def _greedy_split(widths):
    """Simulate the packers' greedy fill (lo from the field list's end,
    hi takes the rest); returns (lo_bits, hi_bits). Fields never
    straddle words, so the budget is checked per word."""
    lo_bits = 0
    i = len(widths) - 1
    while i >= 0 and lo_bits + widths[i] <= 31:
        lo_bits += widths[i]
        i -= 1
    return lo_bits, sum(widths[:i + 1])


def pack_bits(n_states: int, n_transitions: int, P: int):
    """Bit budget for packing one config (state + P slots) into two
    int32 words: (state_bits, slot_bits, fits). Slot values live in
    [-2, T), stored as slot+2; hi stays below bit 30 (the sentinel)."""
    state_bits = max(int(np.ceil(np.log2(max(n_states, 2)))), 1)
    slot_bits = max(int(np.ceil(np.log2(max(n_transitions + 2, 2)))), 1)
    _, hi_bits = _greedy_split([state_bits] + [slot_bits] * P)
    fits = hi_bits <= 29 and state_bits <= 29 and slot_bits <= 29
    return state_bits, slot_bits, fits


class PackPlan(NamedTuple):
    """Exact lossless packing of one config (state + P slots) into
    ``n_words`` int32 sort keys. ``assign[i]`` is the (word, shift) of
    field i, fields = [state, slot_0, .., slot_{P-1}], filled greedily
    from the END of the list into word 0 (least significant), then word
    1, ... Words hold <= 31 bits; the TOP word keeps bits 29/30 free
    for the okp-order flag and the invalid sentinel."""
    state_bits: int
    slot_bits: int
    P: int
    assign: tuple          # ((word, shift), ...) per field
    n_words: int


def make_pack_plan(n_states: int, n_transitions: int,
                   P: int) -> Optional[PackPlan]:
    """The multi-word plan, or None when a single field exceeds 29
    bits (then only the full row lexsort is exact)."""
    state_bits = max(int(np.ceil(np.log2(max(n_states, 2)))), 1)
    slot_bits = max(int(np.ceil(np.log2(max(n_transitions + 2, 2)))), 1)
    widths = [state_bits] + [slot_bits] * P
    if max(widths) > 29:
        return None
    assign: list = [None] * len(widths)
    word, used = 0, 0
    for i in range(len(widths) - 1, -1, -1):
        if used + widths[i] > 31:
            word, used = word + 1, 0
        assign[i] = (word, used)
        used += widths[i]
    if used > 29:
        word += 1              # flags get a fresh top word
    return PackPlan(state_bits, slot_bits, P, tuple(assign), word + 1)


def _pack_plan_words(states, slots, plan: PackPlan):
    """Pack each config row into ``plan.n_words`` int32 words (word 0
    least significant)."""
    fields = [states] + [slots[:, q] + 2 for q in range(plan.P)]
    words = [torch.zeros_like(states) for _ in range(plan.n_words)]
    for f, (w, sh) in zip(fields, plan.assign):
        words[w] = words[w] | (f << sh)
    return words


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis through ``index_select``: the
    same result, without advanced indexing's per-call thread fan-out,
    which costs milliseconds per gather on a busy multi-core host."""
    return x.index_select(0, idx)


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the permutation ordering rows by ``keys``, the
    LAST key primary, as successive stable sorts from the first (least
    significant) key on."""
    order = None
    for k in keys:
        kk = k if order is None else take(k, order)
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else take(order, idx)
    return order


def _word_keys(words):
    """Non-negative 31-bit words (least significant first) folded in
    pairs into int64 keys that order exactly like the words — half the
    stable sorts of :func:`_lexsort`."""
    w64 = [w.to(torch.int64) for w in words]
    return [w64[i] | (w64[i + 1] << 31) if i + 1 < len(w64) else w64[i]
            for i in range(0, len(w64), 2)]


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


def remap_slots_batch(streams):
    """Batched :func:`remap_slots` over many SegmentStreams at once —
    the batch ingest path's form (``checker.batch._stream_segments``).
    Returns ``(streams', p_effs)`` with outputs BIT-IDENTICAL to
    per-history ``remap_slots``.

    The loop runs over SEGMENT POSITIONS with all histories as one
    vector lane each: state is a (B, n_procs) slot map plus a (B, P)
    in-use mask. The lowest-free rule maps onto ``argmax(~used)``
    exactly: slots are allocated contiguously, so the smallest unused
    index is min(free heap) when the heap is non-empty and the fresh
    index otherwise."""
    B = len(streams)
    if B == 0:
        return [], []
    S_max = max(s.ok_proc.shape[0] for s in streams)
    K_max = max(s.inv_proc.shape[1] for s in streams)
    if S_max == 0 or all(int(s.ok_proc.shape[0]) == 0 for s in streams):
        return list(streams), [0] * B
    ip = np.full((B, S_max, K_max), -1, np.int32)
    okp = np.full((B, S_max), -1, np.int32)
    for b, s in enumerate(streams):
        sb, kb = s.inv_proc.shape
        ip[b, :sb, :kb] = s.inv_proc
        okp[b, :sb] = s.ok_proc
    npc = int(max(ip.max(initial=-1), okp.max(initial=-1), 0)) + 1
    slot_of = np.full((B, max(npc, 1)), -1, np.int32)
    # conservative live-slot bound (every ok treated as a release);
    # unmatched-ok edge allocations can exceed it — grown on demand
    opens = np.cumsum((ip >= 0).sum(axis=2), axis=1)
    rel = np.cumsum(okp >= 0, axis=1)
    p_cap = int(max((opens[:, 1:] - rel[:, :-1]).max(initial=0),
                    opens[:, 0].max(initial=0), 1)) + 1
    used = np.zeros((B, p_cap), bool)
    n_slots = np.zeros(B, np.int32)
    out_ip = ip.copy()
    out_ok = okp.copy()
    bidx = np.arange(B)
    for s in range(S_max):
        for k in range(K_max):
            p = ip[:, s, k]
            m = p >= 0
            if not m.any():
                continue
            pc = np.where(m, p, 0)
            if np.any(m & (slot_of[bidx, pc] >= 0)):
                b = int(np.flatnonzero(m & (slot_of[bidx, pc] >= 0))[0])
                raise ValueError(
                    f"process {int(p[b])} invokes in segment {s} while "
                    "an earlier invocation is still open")
            while np.any(m & used.all(axis=1)):
                used = np.pad(used, ((0, 0), (0, used.shape[1])))
            sl = np.argmax(~used, axis=1).astype(np.int32)
            out_ip[m, s, k] = sl[m]
            used[bidx[m], sl[m]] = True
            slot_of[bidx[m], pc[m]] = sl[m]
            n_slots = np.maximum(n_slots, np.where(m, sl + 1, 0))
        o = okp[:, s]
        m = o >= 0
        if not m.any():
            continue
        oc = np.where(m, o, 0)
        sl = slot_of[bidx, oc]
        matched = m & (sl >= 0)
        out_ok[matched, s] = sl[matched]
        used[bidx[matched], sl[matched]] = False
        slot_of[bidx[matched], oc[matched]] = -1
        un = m & ~matched
        if un.any():
            # ok with no open invocation: any free slot is IDLE in
            # every config — reference one (fresh if none), leaving it
            # free, exactly like the per-history path
            while np.any(un & used.all(axis=1)):
                used = np.pad(used, ((0, 0), (0, used.shape[1])))
            fs = np.argmax(~used, axis=1).astype(np.int32)
            out_ok[un, s] = fs[un]
            n_slots = np.maximum(n_slots, np.where(un, fs + 1, 0))
    out = []
    for b, s in enumerate(streams):
        sb, kb = s.inv_proc.shape
        out.append(SegmentStream(
            np.ascontiguousarray(out_ip[b, :sb, :kb]), s.inv_tr,
            np.ascontiguousarray(out_ok[b, :sb]),
            s.seg_index, s.depth))
    return out, [int(x) for x in n_slots]


# --- device helpers ----------------------------------------------------------

def engine_device(succ, device=None) -> torch.device:
    """The device an engine runs on: ``device`` when given, else the
    successor table's when it is a tensor, else ``cuda`` (which raises
    on a host without a card)."""
    from ..utils import resolve_device

    if device is not None:
        return resolve_device(device)
    if isinstance(succ, torch.Tensor):
        return succ.device
    return resolve_device(None)


def as_tensor(a, device, dtype=torch.int32) -> torch.Tensor:
    """``a`` (array or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(
        device=device, dtype=dtype)


def _bits_for(n_states, n_transitions, P):
    """Static :class:`PackPlan` for the multi-word packed dedup, or
    None (-> full row lexsort) when the true memo sizes are unknown or
    a single field won't fit a word."""
    if n_states is None or n_transitions is None:
        return None
    return make_pack_plan(n_states, n_transitions, P)


def _first_true_then_rest(keep: torch.Tensor) -> torch.Tensor:
    """``argsort(~keep, stable=True)``: the kept rows in order, then
    the others in order."""
    return torch.cat([torch.nonzero(keep).flatten(),
                      torch.nonzero(~keep).flatten()])


# --- seg2: the single-history capacity engine ---------------------------------

def _dedup_compact(states, slots, valid, F, plan=None, okp=None):
    """Sort rows into an exact order (valid first) so identical configs
    are adjacent; drop duplicates. Returns ``(states[F], slots[F, P],
    valid[F], n_unique, overflow)``; the first ``min(n, F)`` rows are
    the unique configs in sort order, the rest are don't-care.

    With a :class:`PackPlan` rows pack losslessly into ``plan.n_words``
    words (the sort keys); otherwise the full row is the key. ``okp``
    orders rows whose slot ``okp`` is linearized BEFORE the others, so
    the post-ok survivors are a prefix (the small tier relies on it).
    Invalid rows only need to sort after every valid one: their other
    words are zeroed, which keeps every key a non-negative 31-bit word."""
    pad = torch.zeros(1, dtype=torch.bool, device=valid.device)
    if okp is not None:
        not_ret = (slots[:, okp] != LIN).to(torch.int32)
    if plan is not None:
        words = _pack_plan_words(states, slots, plan)
        top = words[-1]
        if okp is not None:
            # the top word stays < 2^29 by the plan budget; bit 29 is
            # free and below the invalid sentinel (1 << 30)
            top = top | (not_ret << 29)
        top = torch.where(valid, top, 1 << 30)
        words = [torch.where(valid, w, 0) for w in words[:-1]] + [top]
        order = _lexsort(_word_keys(words))
        ws = [take(w, order) for w in words]
        va = take(valid, order)
        eq = ws[0][1:] == ws[0][:-1]
        for w in ws[1:]:
            eq = eq & (w[1:] == w[:-1])
        same = torch.cat([pad, eq & va[:-1]])
    else:
        # full lexsort: last key primary — valid rows first, row order
        P = slots.shape[1]
        keys = [slots[:, q] for q in range(P - 1, -1, -1)] + [states]
        if okp is not None:
            keys.append(not_ret)
        keys.append((~valid).to(torch.int32))
        order = _lexsort(keys)
        st0, sl0, va = (take(states, order), take(slots, order),
                        take(valid, order))
        same = torch.cat([pad, (st0[1:] == st0[:-1])
                          & (sl0[1:] == sl0[:-1]).all(dim=1)
                          & va[:-1]])
    keep = va & ~same
    n = int(keep.sum())
    order2 = _first_true_then_rest(keep)[:F]
    sel = take(order, order2)
    return (take(states, sel), take(slots, sel), take(keep, order2), n,
            n > F)


def _expand(succ, states, slots, valid):
    """One linearization step applied to every (config, pending call):
    F*P candidate rows. Indices are clamped into the table: only
    invalid rows hold out-of-range states, and their candidates are
    invalid."""
    F, P = slots.shape
    calling = slots >= 0
    st = states.clamp(0, succ.shape[0] - 1).long()
    s2 = succ[st[:, None], slots.clamp(0, succ.shape[1] - 1).long()]
    cand_valid = (valid[:, None] & calling & (s2 >= 0)).reshape(F * P)
    cand_slots = slots[:, None, :].expand(F, P, P).clone()
    q = torch.arange(P, device=slots.device)
    cand_slots[:, q, q] = LIN
    return s2.reshape(F * P), cand_slots.reshape(F * P, P), cand_valid


def _closure(succ, states, slots, valid, n_valid, F, P, plan,
             max_iter=None, okp=None):
    """Fixed point of single-call linearization with dedup. The first
    iteration always runs; more run while the frontier grows, nothing
    overflowed and fewer than ``max_iter`` (the pending depth, default
    P+1) ran. Returns ``(states, slots, valid, n, overflow)``."""
    if max_iter is None:
        max_iter = P + 1

    def body(st, sl, va):
        c_st, c_sl, c_va = _expand(succ, st, sl, va)
        return _dedup_compact(torch.cat([st, c_st]),
                              torch.cat([sl, c_sl]),
                              torch.cat([va, c_va]), F, plan=plan,
                              okp=okp)

    st, sl, va, n, ovf = body(states, slots, valid)
    changed, it = n > n_valid, 1
    while changed and not ovf and it < max_iter:
        st, sl, va, n2, ovf = body(st, sl, va)
        changed, n, it = n2 > n, n2, it + 1
    return st, sl, va, n, ovf


def init_seg_carry(F: int, P: int, device=None):
    """Initial carry ``(states, slots, valid, n, status, fail)`` of the
    chunked segmented search: one empty config. The frontier lives on
    ``device`` (``None`` means ``cuda``, as at every entry point); the
    scalars are host ints."""
    from ..utils import resolve_device

    dev = resolve_device(device)
    states = torch.zeros(F, dtype=torch.int32, device=dev)
    slots = torch.full((F, P), IDLE, dtype=torch.int32, device=dev)
    valid = torch.zeros(F, dtype=torch.bool, device=dev)
    valid[0] = True
    return (states, slots, valid, 1, VALID, -1)


def expand_seg_carry(carry, F_new: int):
    """Widen a GOOD chunk-boundary carry to a larger frontier capacity:
    in-place escalation resumes the search at the overflowing chunk
    instead of restarting the whole history. Status/fail are reset —
    the carry must come from before the overflow."""
    states, slots, valid, count, _status, _fail = carry
    pad = F_new - states.shape[0]
    if pad < 0:
        raise ValueError("carry wider than target capacity")
    states = torch.nn.functional.pad(states, (0, pad))
    slots = torch.nn.functional.pad(slots, (0, 0, 0, pad), value=IDLE)
    valid = torch.nn.functional.pad(valid, (0, pad))
    return (states, slots, valid, count, VALID, -1)


def _carry_on(carry, dev):
    """A chunk carry with its frontier as tensors on ``dev`` and its
    scalars as ints (a carry widened on the host by
    :func:`expand_seg_carry_slots` holds numpy arrays)."""
    states, slots, valid, count, status, fail = carry
    return (as_tensor(states, dev), as_tensor(slots, dev),
            as_tensor(valid, dev, torch.bool), int(count), int(status),
            int(fail))


def _seg2_tier(Fs, F):
    """Small-tier capacity actually used: None (big-only) when the
    requested tier can't sit strictly below F."""
    return Fs if (Fs is not None and 0 < Fs < F) else None


def _seg_step(succ, carry, inv, tr, okp, sidx, depth, F, P, plan, Fs):
    """One segment: invokes, closure (small tier first when ``Fs``),
    ok filter. A dead segment or a decided history passes through."""
    states, slots, valid, n, status, fail_at = carry
    if status != VALID or okp < 0:
        return carry
    sl = slots.clone()
    for p, t in zip(inv, tr):
        if p >= 0:
            sl[:, p] = t
    kw = dict(max_iter=depth, okp=okp)
    small = None
    if Fs is not None and n <= Fs:
        # the small tier: valid configs form a contiguous prefix, so
        # the first Fs rows hold the whole frontier
        small = _closure(succ, states[:Fs], sl[:Fs], valid[:Fs], n, Fs,
                         P, plan, **kw)
    if small is not None and not small[4]:
        pad_f = F - Fs
        st = torch.nn.functional.pad(small[0], (0, pad_f))
        sl2 = torch.nn.functional.pad(small[1], (0, 0, 0, pad_f))
        va = torch.nn.functional.pad(small[2], (0, pad_f))
        ovf = False
    else:
        st, sl2, va, _, ovf = _closure(succ, states, sl, valid, n, F, P,
                                       plan, **kw)
    returned = va & (sl2[:, okp] == LIN)
    sl3 = sl2.clone()
    sl3[:, okp] = IDLE
    n2 = int(returned.sum())
    st_new = UNKNOWN if ovf else (INVALID if n2 == 0 else VALID)
    return (st, sl3, returned, n2, st_new,
            fail_at if st_new == VALID else sidx)


def _seg_scan(succ, inv_proc, inv_tr, ok_proc, depth, seg_offset, carry,
              F, P, plan, Fs):
    inv = np.asarray(inv_proc).tolist()
    trs = np.asarray(inv_tr).tolist()
    oks = np.asarray(ok_proc).tolist()
    dps = np.asarray(depth).tolist()
    for i in range(len(oks)):
        if carry[4] != VALID:
            break              # every later segment passes through
        carry = _seg_step(succ, carry, inv[i], trs[i], oks[i],
                          seg_offset + i, dps[i], F, P, plan, Fs)
    return carry


def check_device_seg2(succ, inv_proc, inv_tr, ok_proc, depth, *, F: int,
                      P: int, Fs: int = 32, n_states=None,
                      n_transitions=None, device=None):
    """Adaptive segmented search of one history: each segment's closure
    first runs at the small capacity ``Fs`` and escalates to ``F`` on
    overflow. Returns ``(status, fail_segment, n)`` as ints."""
    dev = engine_device(succ, device)
    succ_t = as_tensor(succ, dev)
    carry = _seg_scan(succ_t, inv_proc, inv_tr, ok_proc, depth, 0,
                      init_seg_carry(F, P, dev), F, P,
                      _bits_for(n_states, n_transitions, P),
                      _seg2_tier(Fs, F))
    return carry[4], carry[5], carry[3]


def check_device_seg2_chunk(succ, inv_proc, inv_tr, ok_proc, depth,
                            seg_offset, carry, *, F: int, P: int,
                            Fs: int = 32, n_states=None,
                            n_transitions=None, device=None):
    """One chunk of the adaptive search: consumes ``carry`` (from
    :func:`init_seg_carry`, :func:`expand_seg_carry` or a previous
    chunk) and returns the updated carry. ``seg_offset`` biases the
    segment indices recorded as the fail segment."""
    dev = engine_device(succ, device)
    return _seg_scan(as_tensor(succ, dev), inv_proc, inv_tr, ok_proc,
                     depth, int(seg_offset), _carry_on(carry, dev), F, P,
                     _bits_for(n_states, n_transitions, P),
                     _seg2_tier(Fs, F))


# --- per-op engine: one history, one step per op -----------------------------

def _count_sync(stats: Optional[dict]) -> None:
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1


def check_device(succ, kind, proc, tr, *, F: int, P: int, n_states=None,
                 n_transitions=None, device=None):
    """The per-op search of one history: one step per row of its step
    stream (:func:`make_stream`), the closure at every ok bounded by
    P+1 iterations. One lane of :func:`check_device_batch`, as the JAX
    package's batch form is the ``vmap`` of this one. Returns
    ``(status, fail_index, n_final)`` as ints; ``fail_index`` is the
    history index of the op at which the frontier died or overflowed.
    The true ``n_states`` / ``n_transitions`` enable the packed dedup
    (:class:`PackPlan`)."""
    st, fa, n = check_device_batch(
        succ, np.asarray(kind)[None], np.asarray(proc)[None],
        np.asarray(tr)[None], F=F, P=P, n_states=n_states,
        n_transitions=n_transitions, device=device)
    return int(st[0]), int(fa[0]), int(n[0])


# --- big-only seg engine: one history, one step per ok ------------------------

def check_device_seg(succ, inv_proc, inv_tr, ok_proc, depth, *, F: int,
                     P: int, n_states=None, n_transitions=None,
                     device=None):
    """Segmented search of one history at capacity F (no small tier):
    one step per ok-op. Returns ``(status, fail_segment, n)`` as ints;
    map ``fail_segment`` through ``SegmentStream.seg_index``."""
    return check_device_seg2(succ, inv_proc, inv_tr, ok_proc, depth, F=F,
                             P=P, Fs=None, n_states=n_states,
                             n_transitions=n_transitions, device=device)


def check_device_seg_chunk(succ, inv_proc, inv_tr, ok_proc, depth,
                           seg_offset, carry, *, F: int, P: int,
                           n_states=None, n_transitions=None, device=None):
    """One chunk of the big-only segmented search (see
    :func:`check_device_seg2_chunk`)."""
    return check_device_seg2_chunk(succ, inv_proc, inv_tr, ok_proc, depth,
                                   seg_offset, carry, F=F, P=P, Fs=None,
                                   n_states=n_states,
                                   n_transitions=n_transitions,
                                   device=device)


def expand_seg_carry_slots(carry, P_new: int):
    """Widen a carry's SLOT axis (streaming sessions whose effective
    concurrency grows mid-stream): new slots pad IDLE, which leaves
    every config's meaning unchanged. Status, fail and count are kept:
    a mid-stream widening, not a capacity escalation. Host numpy, as
    in the JAX package: widenings are rare, and the next chunk moves
    the widened carry to its device."""
    states, slots, valid = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in carry[:3])
    count, status, fail = (np.asarray(int(x), np.int32) for x in carry[3:])
    pad = P_new - slots.shape[1]
    if pad < 0:
        raise ValueError("carry has more slots than target width")
    if pad:
        slots = np.pad(slots, ((0, 0), (0, pad)), constant_values=IDLE)
    return (states, slots, valid, count, status, fail)


# --- lanes: B histories' closures side by side (the vmap forms) ---------------
#
# ``jax.vmap`` of the per-op and the segmented engines runs every lane's
# scan in lockstep, and each lane's ``while_loop`` carry freezes once
# THAT lane's condition is false: a lane stops at its own fixed point,
# its own overflow and its own bound. Here the lanes' frontiers sit in
# one (L*F)-row tensor with the lane id as the leading sort field of the
# dedup, and the freeze is explicit: each closure iteration runs only
# the lanes still iterating (one host read of that set per iteration),
# and a lane's rows are written back only while it iterates. A lane that
# overflowed must not iterate on: its truncated frontier could fit again
# and pass as VALID.

@functools.lru_cache(maxsize=64)
def _plan_key_layout(plan: PackPlan, device):
    """Where :func:`_word_keys` puts each field of ``plan``: per field
    (state, slot_0, ..) its int64 key column and bit shift, as tensors
    on ``device``; the top word's column and bit offset; the number of
    key columns."""
    cols = [w // 2 for w, _ in plan.assign]
    shifts = [sh + 31 * (w % 2) for w, sh in plan.assign]
    top = plan.n_words - 1
    return (torch.tensor(cols, dtype=torch.long, device=device),
            torch.tensor(shifts, dtype=torch.long, device=device),
            top // 2, 31 * (top % 2), (plan.n_words + 1) // 2)


def _lane_keys(states, slots, valid, lane, plan, not_ret):
    """int64 sort keys (columns, least significant first) ordering rows
    by (lane, validity, config): the :class:`PackPlan` words folded in
    pairs as :func:`_word_keys` folds them, built in one shift and one
    scatter-add (fields never overlap). Invalid rows keep only the
    sentinel bit 30 of the top word; ``not_ret`` (or None) is the okp
    flag at its bit 29; the lane goes above the top word, or in a
    column of its own when the top key is full."""
    rows = states.shape[0]
    cols, shifts, tcol, toff, nk = _plan_key_layout(plan, states.device)
    fields = torch.cat([states[:, None], slots + 2], 1).long()
    keys = torch.zeros(rows, nk, dtype=torch.long, device=states.device)
    keys.scatter_add_(1, cols.expand(rows, -1), fields << shifts)
    if not_ret is not None:
        keys[:, tcol] += not_ret.long() << (29 + toff)
    sentinel = torch.zeros(nk, dtype=torch.long, device=states.device)
    sentinel[tcol] = 1 << (30 + toff)
    keys = torch.where(valid[:, None], keys, sentinel)
    if plan.n_words % 2:
        keys[:, -1] |= lane << 31
        return keys
    return torch.cat([keys, lane[:, None]], 1)


def _lane_dedup(states, slots, valid, L, F, plan, okp=None):
    """Exact dedup of L lanes' rows at once. Each lane holds R = rows/L
    rows, lane-major in blocks of F (the frontier) then F*P (its
    candidates). Rows sort by (lane, validity, config); the first
    ``min(n, F)`` kept rows of each lane, in sort order, fill its F-row
    block. ``okp`` (an (L,) tensor of slots) orders each lane's rows
    whose slot ``okp`` is linearized first, as the JAX package's
    ``_dedup_compact`` does for the segmented engine (it decides which
    rows an overflowing lane keeps). Returns ``(states, slots, valid,
    n[L], overflow[L])`` with ``n`` the uncapped unique count."""
    rows = states.shape[0]
    P = slots.shape[1]
    dev = states.device
    nf = L * F
    lane = torch.cat([torch.arange(nf, device=dev) // F,
                      torch.arange(rows - nf, device=dev) // (F * P)])
    not_ret = None
    if okp is not None:
        not_ret = (slots.gather(1, okp.index_select(0, lane)[:, None])[:, 0]
                   != LIN).to(torch.int32)
    if plan is not None:
        keys = _lane_keys(states, slots, valid, lane, plan, not_ret)
    else:
        keys = torch.stack(
            [slots[:, q] for q in range(P - 1, -1, -1)]
            + [torch.where(valid, states, 0)]
            + ([not_ret] if not_ret is not None else [])
            + [(~valid).to(torch.int32), lane.to(torch.int32)], 1).long()
    order = _lexsort(keys.unbind(1))
    ks = take(keys, order)
    va = take(valid, order)
    pad = torch.zeros(1, dtype=torch.bool, device=dev)
    keep = va & ~torch.cat([pad, (ks[1:] == ks[:-1]).all(1) & va[:-1]])
    R = rows // L
    c = torch.cumsum(keep, 0)
    e = c - keep.long()
    base = e[::R]
    n_l = c[R - 1::R] - base
    rank = e - base.repeat_interleave(R)
    block = torch.arange(rows, device=dev) // R
    target = torch.where(keep & (rank < F), block * F + rank, nf)
    sel = torch.zeros(nf + 1, dtype=torch.long, device=dev)
    sel[target] = order          # every dropped row lands on nf
    sel = sel[:nf]
    out_va = (torch.arange(F, device=dev)[None, :]
              < n_l[:, None]).flatten()
    return (take(states, sel), take(slots, sel), out_va, n_l, n_l > F)


def _lane_closure(succ, states, slots, valid, n, L, F, P, plan, max_iter,
                  okp=None, stats=None):
    """L lanes' closures: the first iteration for every lane, then more
    for each lane while its frontier grows, it has not overflowed and
    it has run fewer than its ``max_iter`` (an (L,) tensor)
    iterations. ``okp``: an (L,) tensor for :func:`_lane_dedup`, or
    None. Returns ``(states, slots, valid, n, overflow)``."""

    def body(st, sl, va, lanes, ok_slots):
        c_st, c_sl, c_va = _expand(succ, st, sl, va)
        if stats is not None:
            stats["closure_iterations"] = stats.get(
                "closure_iterations", 0) + 1
            stats["rows"] = stats.get("rows", 0) + st.shape[0]
        return _lane_dedup(torch.cat([st, c_st]), torch.cat([sl, c_sl]),
                           torch.cat([va, c_va]), lanes, F, plan,
                           ok_slots)

    st, sl, va, n2, ovf = body(states, slots, valid, L, okp)
    it = 1
    active = torch.nonzero((n2 > n) & ~ovf & (it < max_iter)).flatten()
    _count_sync(stats)
    while active.numel():
        if active.numel() == L:
            # every lane still iterates: no gather, no write-back
            st, sl, va, s_n, ovf = body(st, sl, va, L, okp)
            grew, n2 = s_n > n2, s_n
            s_ovf = ovf
        else:
            rows = _lane_rows(active, F)
            s_st, s_sl, s_va, s_n, s_ovf = body(
                take(st, rows), take(sl, rows), take(va, rows),
                active.numel(),
                None if okp is None else okp.index_select(0, active))
            grew = s_n > n2.index_select(0, active)
            st = st.index_copy(0, rows, s_st)
            sl = sl.index_copy(0, rows, s_sl)
            va = va.index_copy(0, rows, s_va)
            n2 = n2.index_copy(0, active, s_n)
            ovf = ovf.index_copy(0, active, s_ovf)
        it += 1
        active = active[grew & ~s_ovf
                        & (it < max_iter.index_select(0, active))]
        _count_sync(stats)
    return st, sl, va, n2, ovf


def _lane_rows(lanes: torch.Tensor, F: int) -> torch.Tensor:
    """Frontier rows of ``lanes`` (lane-major, F each)."""
    return (lanes[:, None] * F
            + torch.arange(F, device=lanes.device)).flatten()


def _lane_ok(succ, frontier, lanes, okp, max_iter, n, F, P, plan, stats,
             order_ok=False):
    """Closure then ok filter of ``lanes`` (host ids) whose ok is by
    slot ``okp`` (host ids): writes their rows of ``frontier`` (states,
    slots, valid) and ``n`` in place and returns their new statuses
    (host). ``order_ok`` orders each dedup by the ok's slot (the
    segmented engine's order)."""
    states, slots, valid = frontier
    dev = states.device
    lt = torch.as_tensor(lanes, dtype=torch.long, device=dev)
    rows = _lane_rows(lt, F)
    L = len(lanes)
    ok_t = torch.as_tensor(okp, dtype=torch.long, device=dev)
    st, sl, va, _, ovf = _lane_closure(
        succ, take(states, rows), take(slots, rows), take(valid, rows),
        n.index_select(0, lt), L, F, P, plan,
        torch.as_tensor(max_iter, dtype=torch.long, device=dev),
        ok_t if order_ok else None, stats)
    p_row = ok_t.repeat_interleave(F)
    returned = va & (sl.gather(1, p_row[:, None])[:, 0] == LIN)
    sl.scatter_(1, p_row[:, None], IDLE)
    n3 = returned.reshape(L, F).sum(1)
    st_new = torch.where(ovf, UNKNOWN, torch.where(n3 == 0, INVALID,
                                                   VALID))
    states.index_copy_(0, rows, st)
    slots.index_copy_(0, rows, sl)
    valid.index_copy_(0, rows, returned)
    n.index_copy_(0, lt, n3)
    _count_sync(stats)
    return st_new.cpu().numpy()


def _lane_frontier(B, F, P, dev):
    """B lanes' initial frontiers: one empty config each."""
    states = torch.zeros(B * F, dtype=torch.int32, device=dev)
    slots = torch.full((B * F, P), IDLE, dtype=torch.int32, device=dev)
    valid = (torch.arange(B * F, device=dev) % F) == 0
    return (states, slots, valid), torch.ones(B, dtype=torch.long,
                                              device=dev)


def _lane_invoke(slots, lanes, p, t, F, P):
    """Set slot ``p[i]`` of every row of lane ``lanes[i]`` to ``t[i]``."""
    dev = slots.device
    lt = torch.as_tensor(lanes, dtype=torch.long, device=dev)
    s3 = slots.view(-1, F, P)
    s3[lt, :, torch.as_tensor(p, dtype=torch.long, device=dev)] = \
        torch.as_tensor(t, dtype=torch.int32, device=dev)[:, None]


def check_device_batch(succ, kind, proc, tr, *, F: int, P: int,
                       n_states=None, n_transitions=None, device=None,
                       stats: Optional[dict] = None):
    """The per-op engine over B histories sharing one successor table —
    the JAX package's ``vmap`` of :func:`check_device`, as one batched
    computation over the step streams ``(B, n_pad)``, frontier ``(B*F,
    P)``. The lanes advance in lockstep by ok: at round r every lane
    still VALID applies the invokes before its r-th ok (an invoke only
    sets a slot, so where it falls among other lanes' ops changes
    nothing), then the r-th oks' closures run side by side
    (:func:`_lane_closure`: each lane frozen at its own fixed point,
    overflow or P+1 bound) and filter. So every lane gets exactly its
    per-op result, in half the rounds of a lockstep by op index.
    Returns ``(status[B], fail_index[B], n_final[B])`` int32 tensors,
    fail indices in history terms. ``stats`` receives
    ``closure_iterations``, ``rows`` (frontier rows expanded) and
    ``host_syncs``."""
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    kind = np.asarray(kind)
    proc = np.asarray(proc)
    tr = np.asarray(tr)
    B = kind.shape[0]
    plan = _bits_for(n_states, n_transitions, P)
    frontier, n = _lane_frontier(B, F, P, dev)
    status = np.full(B, VALID, np.int32)
    fail_at = np.full(B, -1, np.int32)
    is_ok = kind == K_OK
    rank = np.cumsum(is_ok, axis=1) - is_ok      # oks before each op
    n_ok = is_ok.sum(axis=1)
    R = int(n_ok.max(initial=0))
    ok_b, ok_t = np.nonzero(is_ok)
    ok_at = np.zeros((B, max(R, 1)), np.int64)  # op index of each ok
    ok_at[ok_b, rank[ok_b, ok_t]] = ok_t
    inv_b, inv_t = np.nonzero(kind == K_INVOKE)
    inv_r = rank[inv_b, inv_t]
    by_r = np.argsort(inv_r, kind="stable")     # lane, then op order
    bounds = np.searchsorted(inv_r[by_r], np.arange(R + 1))
    for r in range(R):
        live = (status == VALID) & (n_ok > r)
        if not live.any():
            break
        sel = by_r[bounds[r]:bounds[r + 1]]
        sel = sel[live[inv_b[sel]]]
        if sel.size:
            b, t = inv_b[sel], inv_t[sel]
            p = proc[b, t]
            # a slot set twice before one ok keeps its later invoke
            _, last = np.unique((b * P + p)[::-1], return_index=True)
            keep = sel.size - 1 - last
            _lane_invoke(frontier[1], b[keep], p[keep], tr[b, t][keep], F,
                         P)
        oks = np.flatnonzero(live)
        t_ok = ok_at[oks, r]
        st = _lane_ok(succ, frontier, oks, proc[oks, t_ok],
                      np.full(oks.size, P + 1), n, F, P, plan, stats)
        status[oks] = st
        fail_at[oks[st != VALID]] = t_ok[st != VALID]
    return (torch.from_numpy(status).to(dev),
            torch.from_numpy(fail_at).to(dev), n.to(torch.int32))


def check_device_seg_batch(succ, inv_proc, inv_tr, ok_proc, depth, *,
                           F: int, P: int, n_states=None,
                           n_transitions=None, device=None,
                           stats: Optional[dict] = None):
    """The big-only segmented engine over B histories — the JAX
    package's ``vmap`` of :func:`check_device_seg`, as one batched
    computation. Segment tensors are per lane: ``(B, S, K)``
    (``inv_proc``, ``inv_tr``), ``(B, S)`` (``ok_proc``, ``depth``);
    each lane's closure is bounded by its own depth. Returns
    ``(status[B], fail_segment[B], n_final[B])`` int32 tensors."""
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    ip = np.asarray(inv_proc)
    it = np.asarray(inv_tr)
    okp = np.asarray(ok_proc)
    dp = np.asarray(depth)
    B, S, K = ip.shape
    plan = _bits_for(n_states, n_transitions, P)
    frontier, n = _lane_frontier(B, F, P, dev)
    status = np.full(B, VALID, np.int32)
    fail_at = np.full(B, -1, np.int32)
    for s in range(S):
        live = np.flatnonzero((status == VALID) & (okp[:, s] >= 0))
        if not live.size:
            continue
        for k in range(K):
            m = live[ip[live, s, k] >= 0]
            if m.size:
                _lane_invoke(frontier[1], m, ip[m, s, k], it[m, s, k], F, P)
        st = _lane_ok(succ, frontier, live, okp[live, s], dp[live, s], n,
                      F, P, plan, stats, order_ok=True)
        status[live] = st
        fail_at[live[st != VALID]] = s
    return (torch.from_numpy(status).to(dev),
            torch.from_numpy(fail_at).to(dev), n.to(torch.int32))


# --- flat engine: B histories, one explicit frontier tensor -------------------
#
# The B frontiers live in ONE (B*F)-row tensor with the batch id packed
# into the top bits of a two-word sort key. Each batch contributes
# exactly F*(P+1) rows to a dedup, valid or not, so its rows after the
# sort are a fixed block and per-batch compaction is arithmetic on row
# indices. The closure runs all batches in LOCKSTEP, as the JAX package
# does: it iterates while any batch grew or overflowed, with overflow
# sticky per batch, up to the segment's depth (the max over the batch).

def flat_pack_bits(B: int, n_states: int, n_transitions: int, P: int):
    """Bit budget including the batch id + invalid flag. Returns
    (batch_bits, state_bits, slot_bits, fits); simulates the greedy
    word split of :func:`_flat_sort_key`, so per-word overflow
    (fragmentation) is caught, not just the total."""
    batch_bits = max(int(np.ceil(np.log2(max(B, 2)))), 1)
    state_bits = max(int(np.ceil(np.log2(max(n_states, 2)))), 1)
    slot_bits = max(int(np.ceil(np.log2(max(n_transitions + 2, 2)))), 1)
    widths = [batch_bits, 1, state_bits] + [slot_bits] * P
    _, hi_bits = _greedy_split(widths)
    fits = hi_bits <= 30 and all(b <= 30 for b in widths)
    return batch_bits, state_bits, slot_bits, fits


@functools.lru_cache(maxsize=64)
def _flat_key_shifts(bits, P: int, device):
    """Bit position of each field (batch, invalid, state, slot_0, ..)
    in ``(hi << 31) | lo``: the greedy split of
    :func:`flat_pack_bits`, lo filled from the end of the field list."""
    batch_bits, state_bits, slot_bits = bits
    widths = [batch_bits, 1, state_bits] + [slot_bits] * P
    pos = [0] * len(widths)
    lo_bits, i = 0, len(widths) - 1
    while i >= 0 and lo_bits + widths[i] <= 31:
        pos[i] = lo_bits
        lo_bits += widths[i]
        i -= 1
    hi_bits = 0
    while i >= 0:
        pos[i] = 31 + hi_bits
        hi_bits += widths[i]
        i -= 1
    return torch.tensor(pos, dtype=torch.long, device=device)


def _flat_sort_key(batch, states, slots, valid, bits):
    """The JAX package's two-word key batch | invalid | state | slots
    (each word below 31 bits) as one int64, ``(hi << 31) | lo``, built
    in one shift and one sum (fields never overlap). Invalid rows'
    state and slot fields are zeroed BEFORE shifting: an invalid
    candidate carries state -1, and a negative field would corrupt the
    batch bits."""
    fields = torch.cat([batch[:, None], (~valid)[:, None],
                        torch.where(valid[:, None],
                                    torch.cat([states[:, None], slots + 2],
                                              1), 0)], 1).long()
    return (fields << _flat_key_shifts(bits, slots.shape[1],
                                       states.device)).sum(1)


def _flat_dedup_compact(batch, states, slots, valid, B, F, bits):
    """Sort all rows by (batch, validity, config) — ``jnp.lexsort((lo,
    hi))`` as one stable sort of ``(hi << 31) | lo`` — dedup adjacent
    equal configs, and compact each batch's survivors into its F-row
    block. ``.at[target].set(mode="drop")`` becomes a scatter into
    ``B*F + 1`` rows whose last (every dropped row's target) is sliced
    off. Returns (states, slots, valid, n[B], overflow[B]), ``n``
    capped at F."""
    rows = states.shape[0]
    R = rows // B
    dev = states.device
    ks, order = torch.sort(_flat_sort_key(batch, states, slots, valid,
                                          bits), stable=True)
    va = take(valid, order)
    pad = torch.zeros(1, dtype=torch.bool, device=dev)
    same = torch.cat([pad, (ks[1:] == ks[:-1]) & va[:-1]])
    keep = va & ~same
    c = torch.cumsum(keep, 0)
    e = c - keep.long()
    block = torch.arange(rows, device=dev) // R
    base = e.reshape(B, R)[:, 0]
    rank = e - base[block]
    n_b = c.reshape(B, R)[:, -1] - base
    target = torch.where(keep & (rank < F), block * F + rank, B * F)
    sel = torch.zeros(B * F + 1, dtype=torch.long, device=dev)
    sel[target] = order          # every dropped row lands on B*F
    sel = sel[:B * F]
    slot_row = torch.arange(B * F, device=dev)
    n_min = torch.minimum(n_b, torch.full_like(n_b, F))
    out_va = (slot_row % F) < n_min[slot_row // F]
    out_st = torch.where(out_va, take(states, sel), 0)
    out_sl = torch.where(out_va[:, None], take(slots, sel), 0)
    return out_st, out_sl, out_va, n_min, n_b > F


def _flat_closure(succ, batch, states, slots, valid, n_b, B, F, P, bits,
                  max_iter=None, stats=None):
    """Fixed point of single-call linearization over the flat frontier,
    all batches in lockstep: the first iteration always runs; more run
    while any batch grew or overflowed and fewer than ``max_iter``
    ran. Overflow is sticky: a truncated frontier stays unsound for its
    batch even if later iterations fit again."""
    if max_iter is None:
        max_iter = P + 1
    dev = states.device
    all_batch = torch.cat([batch, torch.arange(
        B * F * P, dtype=torch.int32, device=dev) // (F * P)])

    def body(st, sl, va, n, ovf_sticky):
        c_st, c_sl, c_va = _expand(succ, st, sl, va)
        st2, sl2, va2, n2, ovf = _flat_dedup_compact(
            all_batch, torch.cat([st, c_st]), torch.cat([sl, c_sl]),
            torch.cat([va, c_va]), B, F, bits)
        if stats is not None:
            stats["closure_iterations"] = stats.get(
                "closure_iterations", 0) + 1
            stats["rows"] = stats.get("rows", 0) + st.shape[0]
        _count_sync(stats)
        changed = bool(((n2 > n) | ovf).any())
        return st2, sl2, va2, n2, ovf_sticky | ovf, changed

    st, sl, va, n, ovf, changed = body(
        states, slots, valid, n_b, torch.zeros(B, dtype=torch.bool,
                                               device=dev))
    it = 1
    while changed and it < max_iter:
        st, sl, va, n, ovf, changed = body(st, sl, va, n, ovf)
        it += 1
    return st, sl, va, n, ovf


def check_device_flat(succ, inv_proc, inv_tr, ok_proc, depth, *, B: int,
                      F: int, P: int, n_states: int, n_transitions: int,
                      device=None, stats: Optional[dict] = None):
    """Check B histories as one flat computation. Segment tensors are
    ``(S, B, K)`` (``inv_proc``, ``inv_tr``), ``(S, B)`` (``ok_proc``)
    and ``(S,)`` (``depth``, the max over the batch); returns
    ``(status[B], fail_segment[B], n_final[B])`` int32 tensors.
    Requires the packed-key budget to fit (:func:`flat_pack_bits`). A
    segment where no history is live changes nothing and is
    skipped."""
    bb, sb, tb, fits = flat_pack_bits(B, n_states, n_transitions, P)
    if not fits:
        # the JAX package asserts; raised here so that ``python -O``
        # keeps the check, with the same class and message
        raise AssertionError("flat engine requires the packed-key budget "
                             "to fit")
    bits = (bb, sb, tb)
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    ip_all = as_tensor(inv_proc, dev, torch.long)
    it_all = as_tensor(inv_tr, dev)
    okp_all = as_tensor(ok_proc, dev, torch.long)
    okp_host = np.asarray(ok_proc)
    depths = np.asarray(depth).tolist()
    S, _, K = ip_all.shape
    rows = B * F
    batch = torch.arange(rows, dtype=torch.int32, device=dev) // F
    bl = batch.long()
    states = torch.zeros(rows, dtype=torch.int32, device=dev)
    slots = torch.full((rows, P), IDLE, dtype=torch.int32, device=dev)
    valid = (torch.arange(rows, device=dev) % F) == 0
    n_b = torch.ones(B, dtype=torch.long, device=dev)
    status = torch.full((B,), VALID, dtype=torch.int32, device=dev)
    fail_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
    status_host = np.full(B, VALID, np.int32)
    for s in range(S):
        if not ((status_host == VALID) & (okp_host[s] >= 0)).any():
            continue
        live_b = (status == VALID) & (okp_all[s] >= 0)
        live_row = live_b[bl]
        sl = slots
        for k in range(K):
            p_row = ip_all[s][bl, k]
            set_mask = live_row & (p_row >= 0)
            col = p_row.clamp(min=0)[:, None]
            cur = sl.gather(1, col)[:, 0]
            sl = sl.scatter(1, col, torch.where(
                set_mask, it_all[s][bl, k], cur)[:, None])
        st2, sl2, va2, n2, ovf = _flat_closure(
            succ, batch, states, sl, valid, n_b, B, F, P, bits,
            max_iter=depths[s], stats=stats)
        okp_row = okp_all[s].clamp(min=0)[bl][:, None]
        returned = va2 & (sl2.gather(1, okp_row)[:, 0] == LIN)
        sl3 = sl2.scatter(1, okp_row, torch.where(
            returned, IDLE, sl2.gather(1, okp_row)[:, 0])[:, None])
        n3 = returned.reshape(B, F).sum(1)
        st_new = torch.where(ovf, UNKNOWN, torch.where(
            n3 == 0, INVALID, VALID)).to(torch.int32)
        status2 = torch.where(live_b, st_new, status)
        fail_at = torch.where(live_b & (st_new != VALID), s, fail_at)
        keep_row = live_row & (status2[bl] == VALID)
        states = torch.where(keep_row, st2, states)
        slots = torch.where(keep_row[:, None], sl3, slots)
        valid = torch.where(keep_row, returned, valid)
        n_b = torch.where(live_b & (status2 == VALID), n3, n_b)
        status = status2
        status_host = status.cpu().numpy()
        _count_sync(stats)
    return status, fail_at, n_b.to(torch.int32)


# --- keys: B histories, (hi, lo) key-pair frontier ----------------------------
#
# Field layout, LSB->MSB: slot_0 .. slot_{P-1}, state, invalid, batch —
# split across lo (bits 0..30) then hi. Slot values: 0 = linearized
# (LIN), 1 = idle (IDLE), t+2 = pending transition t. No field crosses
# the word boundary; every mutation keeps a field in range, so a
# negative delta (shifted into place in two's complement) never
# borrows into its neighbour.

class KeyLayout:
    """Static (word, shift) assignment for each field."""

    def __init__(self, B: int, n_states: int, n_transitions: int,
                 P: int):
        self.P = P
        self.slot_bits = max(int(np.ceil(
            np.log2(max(n_transitions + 2, 2)))), 1)
        self.state_bits = max(int(np.ceil(
            np.log2(max(n_states, 2)))), 1)
        self.batch_bits = max(int(np.ceil(np.log2(max(B, 2)))), 1)
        fields = ([("slot", q, self.slot_bits) for q in range(P)]
                  + [("state", 0, self.state_bits),
                     ("invalid", 0, 1),
                     ("batch", 0, self.batch_bits)])
        self.pos = {}
        word, shift = 0, 0
        for name, idx, width in fields:
            if shift + width > 31:
                word, shift = word + 1, 0
            if width > 31 or word > 1:
                self.fits = False
                return
            self.pos[(name, idx)] = (word, shift)
            shift += width
        self.fits = True

    def get(self, hi, lo, name, idx=0):
        word, shift = self.pos[(name, idx)]
        width = {"slot": self.slot_bits, "state": self.state_bits,
                 "invalid": 1, "batch": self.batch_bits}[name]
        src = lo if word == 0 else hi
        return (src >> shift) & ((1 << width) - 1)

    def add(self, hi, lo, name, idx, delta):
        """Add a (possibly negative, data-dependent) delta to a field."""
        word, shift = self.pos[(name, idx)]
        if word == 0:
            return hi, lo + (delta << shift)
        return hi + (delta << shift), lo

    def slot_dynamic(self, hi, lo, p):
        """Extract slot p where p is a per-row tensor."""
        out = torch.zeros_like(lo)
        for q in range(self.P):
            out = torch.where(p == q, self.get(hi, lo, "slot", q), out)
        return out

    def add_slot_dynamic(self, hi, lo, p, delta):
        for q in range(self.P):
            h2, l2 = self.add(hi, lo, "slot", q, delta)
            hi = torch.where(p == q, h2, hi)
            lo = torch.where(p == q, l2, lo)
        return hi, lo


def _batch_contig_perm(B, F, R, device=None):
    """Row permutation gathering each batch's rows (frontier + P
    candidate chunks, each F-blocked per batch) into contiguous
    (B, R) blocks."""
    idx = torch.arange(B * R, device=device)
    b = idx // R
    rem = idx % R
    c = rem // F
    r = rem % F
    return c * (B * F) + b * F + r


def _k_dedup(hi, lo, valid, inv_hi, inv_lo, B, F):
    """Sort keys (invalid rows replaced by their batch's sentinel so
    they stay in their block), dedup adjacent, compact per batch.

    The batch field is the most significant, so a global sort is the
    per-batch block sorts side by side: gather each batch's rows into
    a block, pad the block to a power of two with its own sentinel
    (sentinels sort to the block's tail and are cut off again), and
    sort every block with :func:`~.pair_sort.pair_sort`. Valid keys
    never equal a sentinel (their invalid bit is clear), so validity
    is recovered from the sorted values."""
    from ..utils import next_pow2
    from .pair_sort import pair_sort

    R = hi.shape[0] // B
    dev = hi.device
    h = torch.where(valid, hi, inv_hi)
    l = torch.where(valid, lo, inv_lo)
    perm = _batch_contig_perm(B, F, R, dev)
    hb = take(h, perm).reshape(B, R)
    lb = take(l, perm).reshape(B, R)
    sent_h = inv_hi[:B * F].reshape(B, F)[:, 0]
    sent_l = inv_lo[:B * F].reshape(B, F)[:, 0]
    R_pad = next_pow2(R)
    if R_pad > R:
        hb = torch.cat([hb, sent_h[:, None].expand(B, R_pad - R)], 1)
        lb = torch.cat([lb, sent_l[:, None].expand(B, R_pad - R)], 1)
    hs2, ls2 = pair_sort(hb.contiguous(), lb.contiguous())
    hs = hs2[:, :R].reshape(-1)
    ls = ls2[:, :R].reshape(-1)
    va = ~((hs == sent_h.repeat_interleave(R))
           & (ls == sent_l.repeat_interleave(R)))
    pad = torch.zeros(1, dtype=torch.bool, device=dev)
    same = torch.cat([pad, (hs[1:] == hs[:-1])
                      & (ls[1:] == ls[:-1]) & va[:-1]])
    keep = va & ~same
    c = torch.cumsum(keep, 0)
    e = c - keep.long()
    row = torch.arange(hi.shape[0], device=dev)
    block = row // R
    base = e.reshape(B, R)[:, 0]
    rank = e - base[block]
    n_b = c.reshape(B, R)[:, -1] - base
    target = torch.where(keep & (rank < F), block * F + rank, B * F)
    out_hi = torch.zeros(B * F + 1, dtype=torch.int32, device=dev)
    out_lo = torch.zeros(B * F + 1, dtype=torch.int32, device=dev)
    out_hi[target] = hs          # every dropped row lands on B*F
    out_lo[target] = ls
    slot_row = torch.arange(B * F, device=dev)
    n_min = torch.minimum(n_b, torch.full_like(n_b, F))
    out_va = (slot_row % F) < n_min[slot_row // F]
    return (out_hi[:B * F], out_lo[:B * F], out_va, n_min.to(torch.int32),
            n_b > F)


def _k_expand(succ, lay: KeyLayout, hi, lo, valid):
    """Candidate keys: for each pending slot q, linearize it — set the
    slot field to LIN (0) and step the state field. Table indices are
    clamped: only invalid rows can hold out-of-range fields."""
    s = lay.get(hi, lo, "state")
    s_ix = s.clamp(0, succ.shape[0] - 1).long()
    c_hi, c_lo, c_va = [], [], []
    for q in range(lay.P):
        tq = lay.get(hi, lo, "slot", q)
        pending = tq >= 2
        s2 = succ[s_ix, (tq - 2).clamp(0, succ.shape[1] - 1).long()]
        ok = valid & pending & (s2 >= 0)
        h2, l2 = lay.add(hi, lo, "slot", q, -tq)       # slot -> LIN
        h2, l2 = lay.add(h2, l2, "state", 0, s2 - s)
        c_hi.append(h2)
        c_lo.append(l2)
        c_va.append(ok)
    return torch.cat(c_hi), torch.cat(c_lo), torch.cat(c_va)


def _k_closure(succ, lay, hi, lo, valid, n_b, inv_hi_all, inv_lo_all,
               B, F, max_iter=None):
    """Batched closure: sticky per-batch overflow; iterates while any
    batch grew or overflowed, at least once, at most ``max_iter``."""
    if max_iter is None:
        max_iter = lay.P + 1

    def body(hi, lo, va, n, ovf_sticky):
        c_hi, c_lo, c_va = _k_expand(succ, lay, hi, lo, va)
        hi2, lo2, va2, n2, ovf = _k_dedup(
            torch.cat([hi, c_hi]), torch.cat([lo, c_lo]),
            torch.cat([va, c_va]), inv_hi_all, inv_lo_all, B, F)
        changed = bool(((n2 > n) | ovf).any())
        return hi2, lo2, va2, n2, ovf_sticky | ovf, changed

    ovf0 = torch.zeros(B, dtype=torch.bool, device=hi.device)
    hi, lo, va, n, ovf, changed = body(hi, lo, valid, n_b, ovf0)
    it = 1
    while changed and it < max_iter:
        hi, lo, va, n, ovf, changed = body(hi, lo, va, n, ovf)
        it += 1
    return hi, lo, va, n, ovf


def check_device_keys(succ, inv_proc, inv_tr, ok_proc, depth, *,
                      B: int, F: int, P: int, n_states: int,
                      n_transitions: int, device=None):
    """The key-packed batch engine: B histories, frontier = (hi, lo)
    int32 pairs, one block sort per closure iteration. Segment tensors
    are ``(S, B, K)`` (``inv_proc``, ``inv_tr``), ``(S, B)``
    (``ok_proc``) and ``(S,)`` (``depth``, the max over the batch).
    Returns ``(status[B], fail_segment[B], n_final[B])`` tensors.

    A segment where no history is live changes nothing and is
    skipped."""
    lay = KeyLayout(B, n_states, n_transitions, P)
    if not lay.fits:
        raise AssertionError("key layout must fit 62 bits")
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    ip_all = as_tensor(inv_proc, dev)
    it_all = as_tensor(inv_tr, dev)
    okp_all = as_tensor(ok_proc, dev)
    depths = np.asarray(depth).tolist()
    S, _, K = ip_all.shape
    rows = torch.arange(B * F, dtype=torch.int32, device=dev)
    batch = (rows // F).long()

    # per-row constants: the batch field and the invalid sentinel
    bword, bshift = lay.pos[("batch", 0)]
    ivword, ivshift = lay.pos[("invalid", 0)]
    zero = torch.zeros_like(rows)
    if bword == 1:
        base_hi, base_lo = (rows // F) << bshift, zero
    else:
        base_hi, base_lo = zero, (rows // F) << bshift
    inv_hi_row = base_hi + ((1 << ivshift) if ivword == 1 else 0)
    inv_lo_row = base_lo + ((1 << ivshift) if ivword == 0 else 0)
    # candidate chunk q holds rows 0..B*F in frontier order, so its
    # batch layout is the frontier's, tiled P times
    inv_hi_all = inv_hi_row.repeat(P + 1)
    inv_lo_all = inv_lo_row.repeat(P + 1)

    # initial frontier: one empty config per batch (all slots IDLE=1)
    idle_lo = idle_hi = 0
    for q in range(P):
        w, sh = lay.pos[("slot", q)]
        if w == 0:
            idle_lo |= 1 << sh
        else:
            idle_hi |= 1 << sh
    hi = base_hi + idle_hi
    lo = base_lo + idle_lo
    va = (torch.arange(B * F, device=dev) % F) == 0
    n_b = torch.ones(B, dtype=torch.int32, device=dev)
    status = torch.full((B,), VALID, dtype=torch.int32, device=dev)
    fail_at = torch.full((B,), -1, dtype=torch.int32, device=dev)

    for s in range(S):
        inv_p, inv_t, ok_p = ip_all[s], it_all[s], okp_all[s]
        live_b = (status == VALID) & (ok_p >= 0)
        if not bool(live_b.any()):
            continue
        live_row = live_b[batch]
        h, l = hi, lo
        for k in range(K):
            p_row = inv_p[batch, k]
            tr_row = inv_t[batch, k]
            m = live_row & (p_row >= 0)
            # slot p: IDLE (1) -> tr+2; delta = tr+1
            h2, l2 = lay.add_slot_dynamic(h, l, p_row.clamp(min=0),
                                          tr_row + 1)
            h = torch.where(m, h2, h)
            l = torch.where(m, l2, l)

        h2, l2, va2, n2, ovf = _k_closure(succ, lay, h, l, va, n_b,
                                          inv_hi_all, inv_lo_all, B, F,
                                          max_iter=depths[s])
        okp_row = ok_p.clamp(min=0)[batch]
        slot_ok = lay.slot_dynamic(h2, l2, okp_row)
        returned = va2 & (slot_ok == 0)                 # LIN
        h3, l3 = lay.add_slot_dynamic(h2, l2, okp_row,
                                      returned.to(torch.int32))
        n3 = returned.reshape(B, F).sum(1).to(torch.int32)
        st_new = torch.where(ovf, UNKNOWN, torch.where(
            n3 == 0, INVALID, VALID)).to(torch.int32)
        status2 = torch.where(live_b, st_new, status)
        fail_at = torch.where(live_b & (st_new != VALID), s, fail_at)
        keep_row = live_row & (status2[batch] == VALID)
        hi = torch.where(keep_row, h3, hi)
        lo = torch.where(keep_row, l3, lo)
        va = torch.where(keep_row, returned, va)
        n_b = torch.where(live_b & (status2 == VALID), n3, n_b)
        status = status2
    return status, fail_at, n_b


# --- the mesh route: one engine call per device -------------------------------

def check_device_keys_sharded(mesh, succ, inv_proc, inv_tr, ok_proc,
                              depth, *, B: int, F: int, P: int,
                              n_states: int, n_transitions: int,
                              engine: str = "keys"):
    """The keys (or flat) engine with the batch axis split over
    ``mesh``, a tuple of D devices: shard d checks histories ``[d*g,
    (d+1)*g)``, g = B / D, by its own engine call on ``mesh[d]`` (the
    keys engine's block sort is the pair-sort kernel there) — pure data
    parallelism, no collectives. B must be a multiple of D (callers pad
    with dead histories). Segment tensors are ``(S, B, K)`` / ``(S, B)``
    / ``(S,)`` as for :func:`check_device_keys`; returns
    ``(status[B], fail_segment[B], n_final[B])`` int32 CPU tensors.

    The shards run one after another from this thread: the keys and
    flat engines sync with the host once per segment, so only their
    final readbacks are gathered at the end."""
    from ..utils import on_device

    D = len(mesh)
    if D < 1 or B % D:
        raise ValueError(f"B={B} must be a multiple of the mesh size {D}")
    g = B // D
    base = check_device_keys if engine == "keys" else check_device_flat
    outs = []
    for d in range(D):
        dev = torch.device(mesh[d])
        sl = slice(d * g, (d + 1) * g)
        with on_device(dev):
            outs.append(base(succ, np.asarray(inv_proc)[:, sl],
                             np.asarray(inv_tr)[:, sl],
                             np.asarray(ok_proc)[:, sl], depth, B=g, F=F,
                             P=P, n_states=n_states,
                             n_transitions=n_transitions, device=dev))
    return tuple(torch.cat([o[i].cpu() for o in outs]) for i in range(3))


def check_sharded(mesh, succ, kind, proc, tr, *, F: int, P: int,
                  n_states=None, n_transitions=None):
    """TEST ORACLE ONLY, as in the JAX package — the per-op engine with
    the batch axis split over ``mesh``: shard d runs
    :func:`check_device_batch` on its lanes on ``mesh[d]``. The batch
    path never takes it (the per-op engine stays a single-device last
    resort there); the mesh tests hold the sharded keys and flat
    engines against it. B must be a multiple of D."""
    from ..utils import on_device

    D = len(mesh)
    B = np.asarray(kind).shape[0]
    if D < 1 or B % D:
        raise ValueError(f"B={B} must be a multiple of the mesh size {D}")
    g = B // D
    outs = []
    for d in range(D):
        dev = torch.device(mesh[d])
        sl = slice(d * g, (d + 1) * g)
        # one call per mesh device, by design: a test oracle, never on
        # the batch path
        with on_device(dev):
            outs.append(check_device_batch(  # analysis: ignore[per-item-dispatch]
                succ, np.asarray(kind)[sl], np.asarray(proc)[sl],
                np.asarray(tr)[sl], F=F, P=P, n_states=n_states,
                n_transitions=n_transitions, device=dev))
    return tuple(torch.cat([o[i].cpu() for o in outs]) for i in range(3))
