"""MXU frontier engine — BFS-as-matmul closure for wide-P histories.

The counterpart of the JAX package's ``checker/mxu.py``. The
segment-search kernel serves P <= 15; genuinely concurrent P >= 16
closures are 2^P frontiers that overflow the seg2 ladder's 65536 cap.
This engine takes them:

- **Configs are bit-packed.** A config (state + P slots) packs
  losslessly into ``PackPlan.n_words`` int32 words
  (:class:`~.linear_torch.PackPlan`); the frontier is W word columns
  of ``B*F`` rows. Invoke / linearize / return are single-word field
  arithmetic.
- **Expansion is a matmul.** The frontier's one-hot config-by-state
  incidence ``[B*F, S]`` multiplies the successor table's value and
  validity planes ``[S, T]``: two bf16 matmuls with fp32 accumulation.
  Exact: operands are 0/1 rows against entries <= ``S_CAP``-1 = 255
  (integers to 256 are exact in bf16) and every output has exactly one
  nonzero partial. cuBLAS may reduce bf16 products in reduced
  precision unless told otherwise, so importing this module sets
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  to False. That flag is process-wide: it holds for every bf16 matmul
  of the importing process, not only this engine's. XLA ran this
  outside any Pallas kernel, so here it is ``torch.matmul``.
- **Dedup is the exact packed-key lexsort**, with one extra top key
  ``batch*2 + invalid``; duplicates are adjacent and compact per batch
  with fixed-block arithmetic.
- **Capacity escalates in place** (:func:`expand_carry`).

``check_device_mxu_batch``, ``check_device_mxu`` and
``check_device_mxu_chunk`` share one B-general core; the single-history
forms are B = 1. The carry lives on the engine's device:
``(words, valid, n[B], status[B], fail[B])``. Each closure iteration
reads one flag back to the host. ``check_device_mxu_megabatch`` advances
B streaming sessions' B = 1 carries in one call (each lane owns its
successor table, so the lanes run one after another through the same
core: bit-equal to B chunk calls). ``DISPATCHES`` counts calls of the
four entries.
"""

from __future__ import annotations

import os as _os

import numpy as np
import torch

from ..utils import resolve_device
from .linear_torch import (INVALID, UNKNOWN, VALID, _lexsort, _word_keys,
                           as_tensor, engine_device, make_pack_plan, take)

#: driver crossover: the segment-search kernel serves P <= 15; this
#: engine owns wider P (bounded in-flight — remap_slots makes P the max
#: CONCURRENT open calls)
MIN_P = 16

#: past this the multi-word sort keys stop paying for themselves; the
#: seg2 ladder still serves such shapes
MAX_P = 32

#: successor-table caps: S_CAP keeps every entry <= 255 so ONE bf16
#: value plane is exact; T_CAP bounds the matmul surface's lane axis
S_CAP = 256
T_CAP = 128

#: frontier ladder (in-place escalation); the top rung is the
#: honest-UNKNOWN threshold, 2x the seg2 ladder's 65536
CAPACITIES = (1024, 8192, 131072)

#: segments per call on the chunked driver path
CHUNK = 1024

#: calls of the public entries this process (a megabatch is one)
DISPATCHES = 0

# the exactness argument needs fp32 accumulation of the bf16 products
# (process-wide, see the module docstring)
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def enabled() -> bool:
    """Escape hatch: ``COMDB2_TPU_MXU=0`` routes wide-P traffic back to
    the seg2 ladder (read per call)."""
    return _os.environ.get("COMDB2_TPU_MXU", "1") != "0"


def bucket_F(F: int) -> int:
    """Bucket a caller frontier budget UP to the smallest
    ``CAPACITIES`` rung that holds it (the top rung when none does)."""
    return next((c for c in CAPACITIES if c >= F), CAPACITIES[-1])


def fits(n_states: int, n_transitions: int, P: int) -> bool:
    """Shape-only capability gate: table inside the matmul caps, P
    inside the key budget, and a lossless PackPlan exists."""
    if P < 1 or P > MAX_P:
        return False
    if n_states > S_CAP or n_transitions > T_CAP:
        return False
    return make_pack_plan(n_states, n_transitions, P) is not None


def serves(n_states: int, n_transitions: int, P: int) -> bool:
    """Driver policy: the engine owns P >= MIN_P."""
    return enabled() and P >= MIN_P and fits(n_states, n_transitions, P)


# --- packed-field arithmetic ------------------------------------------------
#
# fields = [state, slot_0, .., slot_{P-1}] at plan.assign positions;
# slot values stored +2 (LIN -> 0, IDLE -> 1, pending t -> t+2).

def _get(plan, words, fi):
    w, sh = plan.assign[fi]
    width = plan.state_bits if fi == 0 else plan.slot_bits
    return (words[w] >> sh) & ((1 << width) - 1)


def _add(plan, words, fi, delta):
    """Add a (data-dependent) delta to field ``fi``; every mutation
    keeps the field in range, so no borrow can cross fields."""
    w, sh = plan.assign[fi]
    out = list(words)
    out[w] = out[w] + (delta << sh)
    return out


def _get_slot_dyn(plan, words, p):
    """Extract slot ``p`` where ``p`` is a per-row tensor."""
    out = torch.zeros_like(words[0])
    for q in range(plan.P):
        out = torch.where(p == q, _get(plan, words, 1 + q), out)
    return out


def _add_slot_dyn(plan, words, p, delta):
    out = list(words)
    for q in range(plan.P):
        w, sh = plan.assign[1 + q]
        out[w] = out[w] + (torch.where(p == q, delta, 0) << sh)
    return out


def _idle_words(plan) -> list:
    """Host ints: the packed initial config (state 0, all slots IDLE)."""
    vals = [0] * plan.n_words
    for q in range(plan.P):
        w, sh = plan.assign[1 + q]
        vals[w] |= 1 << sh
    return vals


# --- exact dedup --------------------------------------------------------------

def _dedup(words, valid, B: int, F: int):
    """Sort rows by (plan words, ``batch*2+invalid`` top key — primary);
    duplicates are adjacent; compact each batch's survivors into its
    F-row block. Every chunk of the input holds exactly B*F batch-major
    rows, so batch b owns sorted rows [b*R, (b+1)*R). Returns
    ``(words', valid', n_per_batch[B], overflow[B])``."""
    rows = words[0].shape[0]
    R = rows // B
    dev = valid.device
    batch = (torch.arange(rows, dtype=torch.int32, device=dev)
             % (B * F)) // F
    # invalid rows zero their fields but KEEP their batch id; the
    # invalid bit sorts them to their block's tail
    ws = [torch.where(valid, w, 0) for w in words]
    top = batch * 2 + (~valid).to(torch.int32)
    order = _lexsort(_word_keys(ws) + [top])
    ws = [take(w, order) for w in ws]
    tops = take(top, order)
    va = take(valid, order)
    eq = tops[1:] == tops[:-1]
    for w in ws:
        eq = eq & (w[1:] == w[:-1])
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      eq & va[:-1]])
    keep = va & ~same
    c = torch.cumsum(keep, 0)
    e = c - keep.long()
    block = torch.arange(rows, device=dev) // R
    base = e.reshape(B, R)[:, 0]
    rank = e - base[block]
    n_b = c.reshape(B, R)[:, -1] - base
    target = torch.where(keep & (rank < F), block * F + rank, B * F)
    out = []
    for w in ws:
        o = torch.zeros(B * F + 1, dtype=torch.int32, device=dev)
        o[target] = w                      # dropped rows land on B*F
        out.append(o[:B * F])
    slot_row = torch.arange(B * F, device=dev)
    n_min = torch.clamp(n_b, max=F)
    out_va = (slot_row % F) < n_min[slot_row // F]
    return out, out_va, n_min.to(torch.int32), n_b > F


# --- matmul expansion + closure -----------------------------------------------

def _succ_planes(succ: torch.Tensor):
    """Value and validity planes of the (padded) successor table as
    bf16 matmul operands (entries < S_CAP, so bf16-exact)."""
    val = succ.clamp(min=0).to(torch.bfloat16)
    ok = (succ >= 0).to(torch.bfloat16)
    return val, ok


def _expand_surface(plan, succ_val, succ_ok, words):
    """One-hot config-by-state incidence times the successor planes:
    per-(config, transition) successor state and validity, ``[rows,
    T]`` each."""
    S = succ_val.shape[0]
    states = _get(plan, words, 0)
    oh = (states[:, None] == torch.arange(
        S, dtype=torch.int32, device=states.device)[None, :]
          ).to(torch.bfloat16)
    s2 = torch.matmul(oh, succ_val)
    ok = torch.matmul(oh, succ_ok)
    return s2.to(torch.int32), ok > 0.5


def _closure(plan, succ_val, succ_ok, words, valid, n_b, B: int, F: int,
             max_iter: int):
    """Fixed point of single-call linearization over the packed
    frontier: matmul expansion, packed-key dedup, sticky per-batch
    overflow, at most ``max_iter`` iterations (at least one)."""
    P = plan.P
    T = succ_val.shape[1]

    def body(ws, va, n, ovf_sticky):
        s2_all, ok_all = _expand_surface(plan, succ_val, succ_ok, ws)
        states = _get(plan, ws, 0)
        cand_ws = [[w] for w in ws]
        cand_va = [va]
        for q in range(P):
            tq = _get(plan, ws, 1 + q)
            pending = tq >= 2
            # only invalid rows can index past the table
            t_id = (tq - 2).clamp(0, T - 1).long()[:, None]
            s2 = torch.gather(s2_all, 1, t_id)[:, 0]
            okq = torch.gather(ok_all, 1, t_id)[:, 0]
            w2 = _add(plan, ws, 1 + q, -tq)        # slot -> LIN (0)
            w2 = _add(plan, w2, 0, s2 - states)
            for i in range(plan.n_words):
                cand_ws[i].append(w2[i])
            cand_va.append(va & pending & okq)
        ws2, va2, n2, ovf = _dedup([torch.cat(cw) for cw in cand_ws],
                                   torch.cat(cand_va), B, F)
        ovf2 = ovf_sticky | ovf
        # an overflowed batch is pinned UNKNOWN: it does not keep the
        # loop going
        changed = bool(((n2 > n) & ~ovf2).any())
        return ws2, va2, n2, ovf2, changed

    ovf0 = torch.zeros(B, dtype=torch.bool, device=valid.device)
    ws, va, n, ovf, changed = body(words, valid, n_b, ovf0)
    it = 1
    while changed and it < max_iter:
        ws, va, n, ovf, changed = body(ws, va, n, ovf)
        it += 1
    return ws, va, n, ovf


def _plan_for(n_states: int, n_transitions: int, P: int):
    if n_states > S_CAP or n_transitions > T_CAP:
        raise ValueError(f"({n_states}, {n_transitions}) is outside the "
                         "MXU table caps")
    plan = make_pack_plan(n_states, n_transitions, P)
    if plan is None:
        raise ValueError("no lossless PackPlan for this shape")
    return plan


def init_carry(B: int, F: int, P: int, n_states: int, n_transitions: int,
               device=None):
    """Initial carry on ``device`` (``None`` means ``cuda``, as at every
    entry point): one empty config per batch, all slots IDLE."""
    plan = _plan_for(n_states, n_transitions, P)
    dev = resolve_device(device)
    words = tuple(torch.full((B * F,), v, dtype=torch.int32, device=dev)
                  for v in _idle_words(plan))
    valid = (torch.arange(B * F, device=dev) % F) == 0
    return (words, valid, torch.ones(B, dtype=torch.int32, device=dev),
            torch.full((B,), VALID, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev))


def expand_carry(carry, F_new: int):
    """Widen a GOOD chunk-boundary carry to a larger capacity: resume
    at the overflowing chunk instead of restarting. Each batch's F-block
    pads in place; status/fail reset (the carry must predate the
    overflow)."""
    words, valid, n_b, status, _fail = carry
    B = status.shape[0]
    F_old = valid.shape[0] // B
    pad = F_new - F_old
    if pad < 0:
        raise ValueError("carry wider than target capacity")
    words = tuple(torch.nn.functional.pad(w.reshape(B, F_old), (0, pad))
                  .reshape(-1) for w in words)
    valid = torch.nn.functional.pad(valid.reshape(B, F_old),
                                    (0, pad)).reshape(-1)
    return (words, valid, n_b, torch.full_like(status, VALID),
            torch.full_like(status, -1))


def pending_histogram(words, valid, *, P: int, n_states: int,
                      n_transitions: int) -> torch.Tensor:
    """Per-config pending-call counts bucketed on the device: progress
    telemetry reads back P+1 ints, never the packed frontier."""
    plan = _plan_for(n_states, n_transitions, P)
    pend = torch.zeros_like(words[0])
    for q in range(P):
        pend = pend + (_get(plan, words, 1 + q) >= 2).to(torch.int32)
    return torch.bincount(pend.long(), weights=valid.to(torch.float64),
                          minlength=P + 1)[:P + 1].to(torch.int64)


def _scan(succ, inv_proc, inv_tr, ok_proc, depth, carry, seg_offset: int,
          B: int, F: int, P: int, n_states: int, n_transitions: int):
    """The segment loop: ``inv_proc``/``inv_tr`` (S, B, K), ``ok_proc``
    (S, B), ``depth`` (S,) host arrays; a segment where no batch is live
    changes nothing and is skipped."""
    plan = _plan_for(n_states, n_transitions, P)
    succ_val, succ_ok = _succ_planes(succ)
    dev = succ.device
    ip_all = as_tensor(inv_proc, dev)
    it_all = as_tensor(inv_tr, dev)
    okp_all = as_tensor(ok_proc, dev)
    depths = np.asarray(depth).tolist()
    live_any = (np.asarray(ok_proc) >= 0).any(axis=1).tolist()
    S, _, K = ip_all.shape
    batch = torch.arange(B * F, device=dev) // F
    words, va, n_b, status, fail_at = carry
    words = list(words)
    for s in range(S):
        if not live_any[s]:
            continue
        inv_p, inv_t, ok_p = ip_all[s], it_all[s], okp_all[s]
        live_b = (status == VALID) & (ok_p >= 0)
        if not bool(live_b.any()):
            continue
        live_row = live_b[batch]
        ws = list(words)
        for k in range(K):
            p_row = inv_p[batch, k]
            tr_row = inv_t[batch, k]
            m = live_row & (p_row >= 0)
            col = p_row.clamp(min=0)
            cur = _get_slot_dyn(plan, ws, col)
            # absolute set (slot -> tr+2), like the seg2 engine
            ws = _add_slot_dyn(plan, ws, col,
                               torch.where(m, tr_row + 2 - cur, 0))
        ws2, va2, _n2, ovf = _closure(plan, succ_val, succ_ok, ws, va,
                                      n_b, B, F, depths[s])
        okp_row = ok_p.clamp(min=0)[batch]
        returned = va2 & (_get_slot_dyn(plan, ws2, okp_row) == 0)
        ws3 = _add_slot_dyn(plan, ws2, okp_row,
                            returned.to(torch.int32))   # LIN -> IDLE
        n3 = returned.reshape(B, F).sum(1).to(torch.int32)
        st_new = torch.where(ovf, UNKNOWN, torch.where(
            n3 == 0, INVALID, VALID)).to(torch.int32)
        status2 = torch.where(live_b, st_new, status)
        fail_at = torch.where(live_b & (st_new != VALID),
                              seg_offset + s, fail_at).to(torch.int32)
        keep_row = live_row & (status2[batch] == VALID)
        words = [torch.where(keep_row, a, b) for a, b in zip(ws3, words)]
        va = torch.where(keep_row, returned, va)
        n_b = torch.where(live_b & (status2 == VALID), n3, n_b)
        status = status2
    return (tuple(words), va, n_b, status, fail_at)


def check_device_mxu_batch(succ, inv_proc, inv_tr, ok_proc, depth, *,
                           B: int, F: int, P: int, n_states: int,
                           n_transitions: int, device=None):
    """The batched engine: seg arrays ``inv_proc``/``inv_tr`` (S, B, K),
    ``ok_proc`` (S, B), ``depth`` (S,); returns per-batch
    ``(status[B], fail_segment[B], n_final[B])`` tensors."""
    global DISPATCHES
    DISPATCHES += 1
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    carry = init_carry(B, F, P, n_states, n_transitions, dev)
    _, _, n_b, status, fail_at = _scan(
        succ, inv_proc, inv_tr, ok_proc, depth, carry, 0, B, F, P,
        n_states, n_transitions)
    return status, fail_at, n_b


def _single(a, K_axis: bool):
    a = np.asarray(a)
    return a.reshape(a.shape[0], 1, a.shape[1]) if K_axis \
        else a.reshape(a.shape[0], 1)


def check_device_mxu(succ, inv_proc, inv_tr, ok_proc, depth, *, F: int,
                     P: int, n_states: int, n_transitions: int,
                     device=None):
    """Single-history form: seg arrays as ``check_device_seg2`` takes
    them; returns ``(status, fail_segment, n_final)`` as ints."""
    global DISPATCHES
    DISPATCHES += 1
    dev = engine_device(succ, device)
    succ = as_tensor(succ, dev)
    carry = init_carry(1, F, P, n_states, n_transitions, dev)
    _, _, n_b, status, fail_at = _scan(
        succ, _single(inv_proc, True), _single(inv_tr, True),
        _single(ok_proc, False), depth, carry, 0, 1, F, P, n_states,
        n_transitions)
    return int(status[0]), int(fail_at[0]), int(n_b[0])


def check_device_mxu_chunk(succ, inv_proc, inv_tr, ok_proc, depth,
                           seg_offset, carry, *, F: int, P: int,
                           n_states: int, n_transitions: int, device=None):
    """One chunk of the single-history search (B=1 carry from
    :func:`init_carry` / :func:`expand_carry`); ``seg_offset`` biases
    the recorded fail segment. Returns the updated carry."""
    global DISPATCHES
    DISPATCHES += 1
    dev = engine_device(succ, device)
    return _scan(as_tensor(succ, dev), _single(inv_proc, True),
                 _single(inv_tr, True), _single(ok_proc, False), depth,
                 carry, int(seg_offset), 1, F, P, n_states, n_transitions)


def check_device_mxu_megabatch(succs, inv_proc, inv_tr, ok_proc, depth,
                               seg_offset, carries, *, F, P, n_states,
                               n_transitions, device=None):
    """B streaming-session lanes of :func:`check_device_mxu_chunk` in
    one call: ``succs`` and ``carries`` are B-tuples (each session owns
    its memo table and B=1 carry), the delta arrays are lane-major
    ``(B, S, K)`` / ``(B, S)`` (``depth`` too: each lane has its own) or
    lists of per-lane arrays, ``seg_offset`` is ``(B,)``. The batched
    core takes one table, so the lanes run one after another through
    it: every returned carry is the one :func:`check_device_mxu_chunk`
    returns for that lane, bit for bit — and ``F``, ``P``, ``n_states``
    and ``n_transitions`` may be per-lane lists. Returns a B-tuple of
    carries."""
    global DISPATCHES
    DISPATCHES += 1

    def lane(x, b):
        return x[b] if isinstance(x, (list, tuple)) else x

    offs = np.asarray(seg_offset).tolist()
    out = []
    for b, carry in enumerate(carries):
        dev = engine_device(succs[b], device)
        out.append(_scan(as_tensor(succs[b], dev),
                         _single(inv_proc[b], True),
                         _single(inv_tr[b], True),
                         _single(ok_proc[b], False), depth[b], carry,
                         int(offs[b]), 1, lane(F, b), lane(P, b),
                         lane(n_states, b), lane(n_transitions, b)))
    return tuple(out)


__all__ = ["CAPACITIES", "CHUNK", "DISPATCHES", "MAX_P", "MIN_P", "S_CAP",
           "T_CAP", "bucket_F", "check_device_mxu",
           "check_device_mxu_batch", "check_device_mxu_chunk",
           "check_device_mxu_megabatch", "enabled",
           "expand_carry", "fits", "init_carry", "pending_histogram",
           "serves"]
