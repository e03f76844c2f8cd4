"""Segment-search kernel: the whole segment loop of one history, or of a
RESET-marked stream of many histories, in one CUDA launch.

Replaces the JAX package's fused Pallas kernel
``comdb2_tpu/checker/pallas_seg.py`` ``_build_kernel`` (launched from
``_chunk_call``). It computes the same function: segmented just-in-time
linearization over a frontier of at most F=128 packed configs. A
config is a key of ``n_words`` int32 words (least significant first)
holding P slot fields (0 = linearized, 1 = idle, t+2 = pending
transition t) and a state field; invalid lanes hold the sentinel
``hi = 1<<30`` in the top word. Per live segment (``ok_proc >= 0``
while the status is VALID):

- apply up to K invokes (slot p: idle -> tr+2);
- run the closure for at most ``depth`` iterations, stopping at a fixed
  point: expand every pending slot through the successor table
  (index ``s * stride + t``, -1 drops the candidate), union with the
  frontier, exact lexicographic dedup; more than 128 unique configs is
  a sticky overflow that stops the closure -> UNKNOWN;
- keep the configs whose ok-slot linearized and reset that slot to
  idle; an empty frontier -> INVALID at global segment ``off + i``.

What bounds it on the card: neither bytes (the whole input is a few
hundred KB, read once) nor arithmetic, but the serial chain segment x
closure iteration and the latency of each step. So one WARP owns one
segment stream and the chain synchronises with shuffles and
``__syncwarp`` only. A closure iteration does not sort its ``n (P + 1)``
keys: each lane looks its candidates up in the sorted frontier (a binary
search), and only the new ones — after a fixed point, expansions through
newly invoked slots, a handful — are sorted in registers (at most 256,
``R`` = 1, 2, 4 or 8 keys per lane) and merged into the frontier by
rank; an iteration with more new candidates sorts the union in shared
memory. The CTA's warps share one copy of the successor
table; each warp keeps its frontier in shared memory and prefetches its
segment rows into a double-buffered ring with ``cp.async``.

Stream mode (the batch path, ``checker.batch`` engine ``stream``): a
row with ``ok_proc == RESET`` flushes the current history's ``(status,
fail, n)`` into ``results[counter]``, advances the counter and re-seeds
the frontier with the empty config; an INVALID or UNKNOWN history skips
to the next RESET, so it never stops the histories after it. A batch is
packed into G RESET-marked group streams, balanced by segment count,
one warp each, G = SMs x warp-streams per SM (:func:`stream_dispatch`).
:func:`stream_stage` launches without a readback (the results follow
into pinned host memory behind a CUDA event) and :func:`stream_collect`
waits; the mesh route (:func:`stream_stage_sharded`,
:func:`plan_shard_slices`, :func:`merge_stream_shards`) launches once
per device of a mesh, each with its own copy of the table.

Host half (same key layout as the JAX package, so frontiers decode
identically): :class:`SegKernelSpec`, :func:`spec_for`,
:func:`pack_table`, :func:`pack_segments`, :func:`initial_frontier`,
:func:`decode_frontier`, :func:`encode_frontier`, :func:`pack_stream`, :func:`plan_stream_slices`,
:func:`merge_stream_slice`, :func:`plan_groups`. The plain PyTorch
version is :func:`seg_search_reference`; :func:`seg_search` and
:func:`seg_search_stream` run it only for CPU tensors and launch the
CUDA kernel (``kernels/seg_search.cu``) for CUDA tensors.

Not carried over from the TPU design: the per-call history cap
(``MAX_STREAM_B``), the 1024-segment scalar-memory chunking, the (b_pad,
128) results tile and the pool of donated carries. They bound Mosaic's
scalar and vector memories and XLA's buffer reuse; here the stream and
the results live in device memory sized to the batch, and PyTorch's
caching allocator recycles the per-dispatch buffers.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..obs import trace as _obs
from ..utils import next_pow2 as _next_pow2
from ..utils import (compile_guard, on_device, readback_async,
                     resolve_device, upload)
from .linear_torch import INVALID, UNKNOWN, VALID

LANES = 128
F = LANES                 # frontier capacity
CHUNK = 1024              # segments per launch on the chunked path
MAX_TABLE = 8192          # successor-table entries the kernel serves
MAX_K = 8                 # invokes per segment the kernel serves

SENT_HI = 1 << 30
SENT_LO = 0
RESET = -2                # ok_proc marker: flush a history, start the next

WARPS_PER_CTA = 8         # the kernel's MAX_WARPS: warp-streams per CTA


class SegKernelSpec(NamedTuple):
    """Static key layout of one history's search.

    ``slot_pos``/``state_pos`` are (word, shift) per field; word 0 is
    the LEAST significant sort key, word ``n_words - 1`` the most."""
    P: int                 # slot count (<= rows - 1)
    K: int                 # invokes per segment
    slot_bits: int
    state_bits: int
    slot_pos: tuple
    state_pos: tuple
    rows: int              # 8 (P <= 7) or 16 (P <= 15): tier of the gate
    n_words: int           # int32 key words per config (1..3)

    @property
    def n_keys(self) -> int:
        """Large-closure buffer capacity: frontier plus P candidate
        blocks, padded to a power of two."""
        return _next_pow2(LANES * (self.P + 1))


def spec_for(n_states: int, n_transitions: int, P: int,
             K: int) -> Optional[SegKernelSpec]:
    """The key layout, or None when the kernel does not serve this
    shape: P > 15, K > 8, a table over 8192 entries, or keys wider than
    3 words. The gate and the (word, shift) layout are the JAX
    package's (``pallas_seg.spec_for``)."""
    if K > MAX_K:
        return None
    rows = 8 if P <= 7 else 16
    if P > rows - 1:
        return None
    if n_states * n_transitions > MAX_TABLE:
        return None
    slot_bits = max(int(np.ceil(np.log2(max(n_transitions + 2, 2)))), 1)
    state_bits = max(int(np.ceil(np.log2(max(n_states, 2)))), 1)
    pos = []
    word, shift = 0, 0
    for width in [slot_bits] * P + [state_bits]:
        if width > 29:
            return None
        if shift + width > 31:
            word, shift = word + 1, 0
        pos.append((word, shift))
        shift += width
    # the top word keeps bits 29/30 free so the sentinel 1<<30 sorts
    # after every valid key; spill to a fresh word when the last field
    # crosses bit 30
    n_words = word + 1
    if shift > 30:
        n_words += 1
    if n_words > 3:
        return None
    return SegKernelSpec(P, K, slot_bits, state_bits, tuple(pos[:P]),
                         pos[P], rows, n_words)


def pack_table(succ: np.ndarray) -> np.ndarray:
    """Flatten the exact ``(n_states, n_transitions)`` successor table
    row-major into int32 (one -1 entry when it is empty)."""
    flat = np.ascontiguousarray(succ, np.int32).reshape(-1)
    return flat if flat.size else np.full(1, -1, np.int32)


def pack_segments(segs, spec: SegKernelSpec) -> np.ndarray:
    """SegmentStream -> int32[S, 2+2K] rows ``(ok_proc, depth,
    inv_proc[K], inv_tr[K])``; missing invokes are -1."""
    S = segs.ok_proc.shape[0]
    K = spec.K
    out = np.zeros((S, 2 + 2 * K), np.int32)
    out[:, 0] = segs.ok_proc
    out[:, 1] = segs.depth
    k_in = segs.inv_proc.shape[1]
    out[:, 2:2 + k_in] = segs.inv_proc
    out[:, 2 + K:2 + K + k_in] = segs.inv_tr
    if k_in < K:
        out[:, 2 + k_in:2 + K] = -1
    return out


def _root_key(spec: SegKernelSpec):
    """Per-word ints (least significant first) of the empty config
    (all slots IDLE, state 0)."""
    words = [0] * spec.n_words
    for q in range(spec.P):
        w, sh = spec.slot_pos[q]
        words[w] |= 1 << sh
    return words


def initial_frontier(spec: SegKernelSpec) -> np.ndarray:
    """int32[n_words, 128]: lane 0 = the empty config, every other
    lane the sentinel."""
    ws = np.full((spec.n_words, LANES), SENT_LO, np.int32)
    ws[-1, :] = SENT_HI
    ws[:, 0] = _root_key(spec)
    return ws


def _init_stat() -> np.ndarray:
    """Initial carry ``[status, fail, n, hist-counter]``."""
    return np.array([VALID, -1, 1, -1], np.int32)


def decode_frontier(spec: SegKernelSpec, ws, P: int):
    """Decode a frontier (int32[n_words, 128], array or tensor) into
    host configs ``(state, slots)`` in the :mod:`.linear_host`
    encoding: the slot field stores LIN=0 / IDLE=1 / tr+2, so
    subtracting 2 maps straight to LIN=-2 / IDLE=-1 / tr. Slots beyond
    ``P`` are dropped (always IDLE)."""
    if isinstance(ws, torch.Tensor):
        ws = ws.cpu().numpy()
    ws = np.asarray(ws)

    def field(pos, bits):
        word, sh = pos
        return (ws[word] >> sh) & ((1 << bits) - 1)

    state = field(spec.state_pos, spec.state_bits)
    nq = min(P, spec.P)
    slots = [field(spec.slot_pos[q], spec.slot_bits) for q in range(nq)]
    out = set()
    for lane in np.flatnonzero(ws[-1] < SENT_HI):
        out.add((int(state[lane]),
                 tuple(int(slots[q][lane]) - 2 for q in range(nq))))
    return out


def encode_frontier(spec: SegKernelSpec, configs) -> np.ndarray:
    """The inverse of :func:`decode_frontier`: host configs ``(state,
    slots)`` (LIN=-2 / IDLE=-1 / tr; slots past ``len(slots)`` IDLE) as
    an int32[n_words, 128] frontier under ``spec``, live lanes in
    ascending key order (most significant word last) and the sentinel
    after — the layout the kernel reads and writes. At most 128
    configs."""
    keys = []
    for state, slots in configs:
        words = _root_key(spec)
        w, sh = spec.state_pos
        words[w] |= int(state) << sh
        for q, t in enumerate(slots):
            w, sh = spec.slot_pos[q]
            words[w] += (int(t) + 1) << sh      # IDLE (1) -> t + 2
        keys.append(words)
    if len(keys) > LANES:
        raise ValueError(f"{len(keys)} configs exceed the frontier's "
                         f"{LANES} lanes")
    keys.sort(key=lambda ws: ws[::-1])
    out = np.full((spec.n_words, LANES), SENT_LO, np.int32)
    out[-1, :] = SENT_HI
    for lane, words in enumerate(keys):
        out[:, lane] = words
    return out


# --- the plain PyTorch version ----------------------------------------------

def _unique_keys(keys: torch.Tensor) -> torch.Tensor:
    """Exact dedup of (n, W) int64 keys, sorted ascending with the
    most significant word LAST (the kernel's order)."""
    if keys.shape[0] == 0:
        return keys
    return torch.unique(keys.flip(1), dim=0).flip(1)


def seg_search_reference(seg: torch.Tensor, off: int, stride: int,
                         ws: torch.Tensor, stat: torch.Tensor,
                         table: torch.Tensor, spec: SegKernelSpec,
                         work: Optional[dict] = None,
                         results: Optional[torch.Tensor] = None):
    """The segment search as a set-semantics loop of torch ops, on the
    inputs' device. Same contract as :func:`seg_search`: returns
    ``(status, fail, n, ws_out)`` with ``ws_out`` int32[n_words, 128]
    (survivors first, sentinel after).

    ``results`` (int32[H, 3]) selects stream mode: each RESET row writes
    ``(status, fail, n)`` to ``results[counter]`` when the counter
    (``stat[3]``) is in ``[0, H)``, then restarts from the empty config.

    ``work``, when given, accumulates ``keys`` (the ``m = n * (P + 1)``
    keys of every closure iteration, summed) and ``compares`` (``m *
    floor(log2 m)`` comparisons to sort them plus ``m - 1`` to find the
    duplicates), which the kernel's ``work`` counter reproduces: a
    parity check of the iterations run, not a bound (the closures need
    fewer, see :func:`needed_compares`)."""
    dev = ws.device
    W, P = spec.n_words, spec.P
    K = (seg.shape[1] - 2) // 2
    fr = ws[:, ws[W - 1] < SENT_HI].T.to(torch.int64)
    status, fail, n_stat, counter = (int(x) for x in stat.tolist())
    tab = table.to(torch.int64)
    tsize = tab.numel()
    slot_mask = (1 << spec.slot_bits) - 1
    state_mask = (1 << spec.state_bits) - 1
    sw, ssh = spec.state_pos
    slot_w = torch.tensor([w for w, _ in spec.slot_pos], device=dev,
                          dtype=torch.int64)
    slot_sh = torch.tensor([s for _, s in spec.slot_pos], device=dev,
                           dtype=torch.int64)
    # per-slot / state field unit, placed in its word: (P, W) and (W,)
    slot_unit = torch.zeros((P, W), dtype=torch.int64, device=dev)
    slot_unit[torch.arange(P, device=dev), slot_w] = 1 << slot_sh
    state_unit = torch.zeros(W, dtype=torch.int64, device=dev)
    state_unit[sw] = 1 << ssh

    def slots_of(keys):                       # (n, P)
        return (keys[:, slot_w] >> slot_sh) & slot_mask

    root = torch.tensor([_root_key(spec)], dtype=torch.int64, device=dev)
    for i, row in enumerate(seg.tolist()):
        okp, depth = row[0], row[1]
        if okp == RESET:
            if results is None:
                continue
            if 0 <= counter < results.shape[0]:
                results[counter] = torch.tensor([status, fail, n_stat],
                                                dtype=torch.int32)
            counter += 1
            status, fail, n_stat, fr = VALID, -1, 1, root
            continue
        if status != VALID:
            if results is None:
                break
            continue               # skip to the next RESET
        if okp < 0:
            continue
        for k in range(K):
            p, tr = row[2 + k], row[2 + K + k]
            if 0 <= p < P:
                fr = fr + (tr + 1) * slot_unit[p]
        ovf = False
        n = fr.shape[0]
        for _ in range(depth):
            m = n * (P + 1)
            if work is not None and m > 0:
                work["keys"] = work.get("keys", 0) + m
                work["compares"] = (work.get("compares", 0)
                                    + m * (m.bit_length() - 1) + m - 1)
            s = (fr[:, sw] >> ssh) & state_mask
            tq = slots_of(fr)
            idx = s[:, None] * stride + (tq - 2).clamp(min=0)
            s2 = torch.where(idx < tsize, tab[idx.clamp(max=tsize - 1)],
                             torch.full_like(idx, -1))
            ok = (tq >= 2) & (s2 >= 0)
            cand = (fr[:, None, :] - tq[:, :, None] * slot_unit[None]
                    + (s2 - s[:, None])[:, :, None] * state_unit)
            u = _unique_keys(torch.cat([fr, cand[ok]]))
            n2 = u.shape[0]
            if n2 > F:
                ovf = True
                fr = u[:F]
                break
            changed = n2 > n
            fr, n = u, n2
            if not changed:
                break
        if okp < P:
            ret = slots_of(fr)[:, okp] == 0
            fr = fr[ret] + slot_unit[okp]
        n_stat = fr.shape[0]
        status = (UNKNOWN if ovf else
                  INVALID if n_stat == 0 else VALID)
        if status != VALID:
            fail = off + i
    out = torch.full((W, LANES), SENT_LO, dtype=torch.int32, device=dev)
    out[W - 1] = SENT_HI
    out[:, :fr.shape[0]] = fr.T.to(torch.int32)
    return status, fail, n_stat, out


# --- the CUDA kernel's wrapper ------------------------------------------------

def needed_compares(ms, P: int) -> int:
    """The comparisons a stream's closures need at the least, from the
    key counts ``m = n * (P + 1)`` of its closure iterations in order
    (those with ``m > 0``): the ``n`` frontier keys are sorted already,
    so each of the ``n * P`` expansions needs one binary search into
    them, ``ceil(log2(n + 1))`` comparisons; and the ``u`` keys by which
    an iteration's ``n`` exceeds the previous one's (the new keys that
    iteration added) need ``u * ceil(log2 u)`` to sort. The operation
    count of the kernel's roofline bound, which its ``need`` counter
    reproduces."""
    total, prev = 0, None
    for m in ms:
        n = m // (P + 1)
        u = n - prev if prev is not None and n > prev else 0
        total += n * P * n.bit_length() + u * max(u - 1, 0).bit_length()
        prev = n
    return total


def _check_inputs(seg, ws, stat, table, spec: SegKernelSpec,
                  results=None, work=None, need=None) -> None:
    """Single-history shapes, or with a leading G axis on ``seg``,
    ``ws`` and ``stat``, one warp stream each (stream mode: ``results``
    int32[G, H, 3]; ``work`` and ``need`` int64[G] or None)."""
    dev = ws.device
    lead = tuple(seg.shape[:-2])
    named = [("seg", seg), ("ws", ws), ("stat", stat), ("table", table)]
    if results is not None:
        named.append(("results", results))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, ws on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.dim() not in (2, 3) or seg.shape[-1] != 2 + 2 * spec.K:
        raise ValueError(f"seg shape {tuple(seg.shape)} != ([G,] S, "
                         f"{2 + 2 * spec.K})")
    if tuple(ws.shape) != lead + (spec.n_words, LANES):
        raise ValueError(f"ws shape {tuple(ws.shape)} != "
                         f"{lead + (spec.n_words, LANES)}")
    if tuple(stat.shape) != lead + (4,):
        raise ValueError(f"stat shape {tuple(stat.shape)} != "
                         f"{lead + (4,)}")
    if table.dim() != 1 or not 0 < table.numel() <= MAX_TABLE:
        raise ValueError(f"table must be 1-D with 1..{MAX_TABLE} "
                         f"entries, got {tuple(table.shape)}")
    if results is not None and (results.dim() != 3
                                or tuple(results.shape[:1]) != lead
                                or results.shape[2] != 3):
        raise ValueError(f"results shape {tuple(results.shape)} != "
                         f"{lead + ('H', 3)}")
    for name, t in (("work", work), ("need", need)):
        if t is not None and (t.dtype != torch.int64
                              or tuple(t.shape) != (lead or (1,))
                              or t.device != dev):
            raise ValueError(f"{name} must be int64 with one entry per "
                             "stream")


def launch_geometry(n_streams: int, sms: int):
    """``(CTAs, warps per CTA)`` of a launch of ``n_streams`` warp
    streams: a launch of up to one stream per SM runs one warp per CTA,
    so its CTAs spread over the SMs; a larger one packs up to
    ``WARPS_PER_CTA`` warps into each CTA, which share one copy of the
    successor table."""
    n_streams = max(n_streams, 1)
    warps = min(WARPS_PER_CTA, max(-(-n_streams // max(sms, 1)), 1))
    return -(-n_streams // warps), warps


def _launch(seg, off: int, stride: int, ws, stat, table,
            spec: SegKernelSpec, results=None, work=None, need=None,
            lib=None):
    """One kernel launch on the current stream, one warp per leading
    index of ``seg`` (or one warp for a 2-D ``seg``), CTAs and warps per
    CTA from :func:`launch_geometry`; returns the output
    carry ``(ws_out, stat_out)`` without synchronising. ``results``
    selects stream mode; ``work`` receives each stream's comparison
    count as :func:`seg_search_reference` counts it, ``need`` the count
    of :func:`needed_compares`. ``lib`` is the loaded library to launch
    (default: the plain build, ``build.load()``)."""
    from ..kernels import build

    lib = build.load() if lib is None else lib
    _check_inputs(seg, ws, stat, table, spec, results, work, need)
    ws_out = torch.empty_like(ws)
    stat_out = torch.empty_like(stat)
    lay = build.layout(spec)
    batch = seg.shape[0] if seg.dim() == 3 else 1
    sms = torch.cuda.get_device_properties(ws.device).multi_processor_count
    _, warps = launch_geometry(batch, sms)
    stream = torch.cuda.current_stream(ws.device)
    begun = compile_guard.launch_begins(stream)
    err = lib.seg_search_launch(
        seg.data_ptr(), seg.shape[-2], off, stride, ws.data_ptr(),
        stat.data_ptr(), table.data_ptr(), table.numel(),
        ws_out.data_ptr(), stat_out.data_ptr(), batch, warps,
        ctypes.byref(lay),
        None if results is None else results.data_ptr(),
        0 if results is None else results.shape[1],
        None if work is None else work.data_ptr(),
        None if need is None else need.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_search launch failed: CUDA error {err} "
                           f"({build.error_string(err)})")
    compile_guard.note_launch(
        "seg_search" if results is None else "seg_search_stream",
        (spec.P, spec.K, spec.n_words), begun, stream)
    return ws_out, stat_out


def seg_search(seg: torch.Tensor, off: int, stride: int,
               ws: torch.Tensor, stat: torch.Tensor, table: torch.Tensor,
               spec: SegKernelSpec):
    """Run segments ``seg`` (int32[S, 2+2K]) from carry ``(ws, stat)``.
    ``off`` is the global index of ``seg[0]`` (fail indices are global),
    ``stride`` the table's row stride (the exact n_transitions).
    Returns ``(status, fail, n, ws_out)``.

    CPU tensors run :func:`seg_search_reference`; CUDA tensors launch
    the kernel, and a failed build or launch raises."""
    if not ws.is_cuda:
        return seg_search_reference(seg, off, stride, ws, stat, table,
                                    spec)
    ws_out, stat_out = _launch(seg, off, stride, ws, stat, table, spec)
    status, fail, n, _ = stat_out.tolist()
    return status, fail, n, ws_out


def _prepare(succ, segs, n_states, n_transitions, P, device):
    """Spec gate, then the packed segment stream, initial carry and
    exact successor table as tensors on ``device``; None when the
    kernel does not serve the shape."""
    spec = spec_for(n_states, n_transitions, P, segs.inv_proc.shape[1])
    if spec is None:
        return None
    dev = resolve_device(device)
    seg = torch.from_numpy(pack_segments(segs, spec)).to(dev)
    ws = torch.from_numpy(initial_frontier(spec)).to(dev)
    stat = torch.from_numpy(_init_stat()).to(dev)
    table = torch.from_numpy(
        pack_table(np.asarray(succ)[:n_states, :n_transitions])).to(dev)
    return spec, seg, ws, stat, table


def check_device_seg_kernel(succ: np.ndarray, segs, *, n_states: int,
                            n_transitions: int, P: int, device=None):
    """Search one history in ONE launch. Returns ``(status, fail_seg,
    n)`` as ints, or None when the kernel does not serve the shape."""
    prep = _prepare(succ, segs, n_states, n_transitions, P, device)
    if prep is None:
        return None
    spec, seg, ws, stat, table = prep
    status, fail, n, _ = seg_search(seg, 0, n_transitions, ws, stat,
                                    table, spec)
    return status, fail, n


def check_device_seg_kernel_chunked(succ: np.ndarray, segs, *,
                                    n_states: int, n_transitions: int,
                                    P: int, device=None, progress=None,
                                    progress_interval_s: float = 5.0,
                                    s_real: Optional[int] = None,
                                    return_boundary: bool = False,
                                    chunk: int = CHUNK):
    """One launch per ``chunk`` segments, returning to the host between
    launches so ``progress(done, total, frontier_n, stats)`` can fire
    (the reference's 5-second reporter cadence, ``linear.clj:273-297``).

    With ``return_boundary`` the result gains a 4th element
    ``(ws, done)``: the frontier at the last chunk boundary BEFORE the
    failure and the number of segments consumed up to it — the seed
    for bounded counterexample reconstruction (decode with
    :func:`decode_frontier`)."""
    from .linear_torch import estimated_cost

    prep = _prepare(succ, segs, n_states, n_transitions, P, device)
    if prep is None:
        return None
    spec, seg, ws, stat, table = prep
    S = seg.shape[0]
    s_real = s_real if s_real is not None else segs.ok_proc.shape[0]
    status, fail, n, counter = _init_stat().tolist()
    t_run = _obs.monotonic()
    last = t_run
    prev_ws, done = ws, 0
    visited = 0
    for c in range(max(-(-S // chunk), 1)):
        stat = torch.tensor([status, fail, n, counter],
                            dtype=torch.int32, device=ws.device)
        status, fail, n, ws = seg_search(
            seg[c * chunk:(c + 1) * chunk], c * chunk, n_transitions,
            ws, stat, table, spec)
        visited += n * chunk
        if status != VALID:
            break
        prev_ws, done = ws, (c + 1) * chunk
        now = _obs.monotonic()
        if progress is not None and now - last >= progress_interval_s:
            cfgs = decode_frontier(spec, ws, spec.P)
            pend = [sum(1 for t in sl if t >= 0) for _, sl in cfgs]
            el = max(now - t_run, 1e-9)
            progress(min((c + 1) * chunk, s_real), s_real, n,
                     {"visited_per_s": visited / el,
                      "segs_per_s": done / el,
                      "est_cost": estimated_cost(pend)})
            last = now
    out = (status, fail, n)
    if return_boundary:
        return out + ((prev_ws, min(done, s_real)),)
    return out


# --- stream mode: many histories per launch ----------------------------------

def pack_stream(segs_list, spec: SegKernelSpec, chunk: int = 1):
    """Concatenate per-history segment streams into one stream with
    RESET markers: [R][h0][R][h1]...[R]. The first R starts history 0
    (the counter begins at -1, so nothing is flushed); each later R
    flushes the previous history; the trailing R flushes the last.
    Returns ``(rows int32[n, 2+2K], starts int64[B])``, ``n`` padded
    with dead rows to a multiple of ``chunk``; ``starts[b]`` is history
    b's first segment's index in the stream."""
    total = sum(s.ok_proc.shape[0] for s in segs_list) + len(segs_list) + 1
    flat = np.empty((max(-(-total // chunk), 1) * chunk, 2 + 2 * spec.K),
                    np.int32)
    return flat, _fill_stream(flat, segs_list, spec)


def _fill_stream(flat: np.ndarray, segs_list, spec: SegKernelSpec):
    """Write :func:`pack_stream`'s rows into ``flat`` (int32[n, 2+2K],
    n at least the stream's rows; every row is written, the rows past
    the stream as dead padding). Returns ``starts``."""
    K = spec.K
    starts = np.zeros(len(segs_list), np.int64)
    pos = 0
    for b, segs in enumerate(segs_list):
        S = segs.ok_proc.shape[0]
        k_in = segs.inv_proc.shape[1]
        flat[pos] = 0
        flat[pos, 0] = RESET
        pos += 1
        starts[b] = pos
        rows = flat[pos:pos + S]
        rows[:, 0] = segs.ok_proc
        rows[:, 1] = segs.depth
        rows[:, 2:2 + k_in] = segs.inv_proc
        rows[:, 2 + k_in:2 + K] = -1
        rows[:, 2 + K:2 + K + k_in] = segs.inv_tr
        rows[:, 2 + K + k_in:] = 0
        pos += S
    flat[pos] = 0
    flat[pos, 0] = RESET                  # trailing flush
    flat[pos + 1:] = 0
    flat[pos + 1:, 0] = -1                # dead padding
    return starts


def plan_stream_slices(B: int, n_devices: int,
                       max_stream_b: Optional[int] = None):
    """Pure slice assignment: ``[(start, end, device_index), ...]``
    covering ``range(B)`` in order, slices capped at ``max_stream_b``
    histories (default: no cap — one slice) and, when ``n_devices`` >
    0, sized to spread the batch across the devices round-robin.

    The batch path's pipelining plan (``checker.batch``): slice i
    launches before slice i+1 is packed."""
    cap = max(B, 1) if max_stream_b is None else max_stream_b
    group = min(cap, -(-B // n_devices)) if n_devices > 0 else cap
    return [(i, min(i + group, B),
             ((i // group) % n_devices) if n_devices > 0 else 0)
            for i in range(0, B, group)]


def merge_stream_slice(res: np.ndarray, starts, n: int):
    """Pure verdict unpacking: the kernel reports fail segments in
    stream coordinates; callers need them history-local. Returns
    ``[(status, fail_seg_local, n_final), ...]``."""
    out = []
    for b in range(n):
        st = int(res[b, 0])
        fail_g = int(res[b, 1])
        fail_local = fail_g - int(starts[b]) if fail_g >= 0 else -1
        out.append((st, fail_local, int(res[b, 2])))
    return out


def plan_groups(sizes, G: int):
    """Balance histories over ``G`` group streams by segment count
    (longest first onto the lightest group). Returns one list of
    history indices per non-empty group, each in ascending order."""
    G = max(min(G, len(sizes)), 1)
    heap = [(0, g) for g in range(G)]
    groups = [[] for _ in range(G)]
    for b in sorted(range(len(sizes)), key=lambda b: (-sizes[b], b)):
        load, g = heapq.heappop(heap)
        groups[g].append(b)
        heapq.heappush(heap, (load + sizes[b] + 1, g))
    return [sorted(g) for g in groups if g]


#: streaming multiprocessors of an H100; the group count on CPU tensors
#: (where no card can be asked)
SM_COUNT = 132


def warp_streams_per_sm(spec: SegKernelSpec, table_n: int) -> int:
    """Warp streams of this layout one SM holds at once (CTAs of
    ``WARPS_PER_CTA`` warps per SM, from the occupancy API, times
    ``WARPS_PER_CTA``); card only."""
    from ..kernels import build

    per_sm = build.load().seg_search_occupancy(
        ctypes.byref(build.layout(spec)), table_n)
    if per_sm < 1:
        raise RuntimeError("seg_search: no CTA of this layout fits an SM")
    return per_sm


def kernel_attrs(lib=None):
    """What the loaded library's kernels were compiled to, read from the
    library itself (so the same on a fresh or a cached build): by key
    width ``W`` (1, 2, 3), ``registers`` and ``local_bytes`` (spills)
    per thread, ``static_smem_bytes`` and ``max_threads`` per CTA, and
    ``smem_optin_bytes``, the dynamic shared memory a CTA of the current
    device may opt into. Card only."""
    from ..kernels import build

    lib = build.load() if lib is None else lib
    attrs = {}
    for W in (1, 2, 3):
        out = (ctypes.c_int * 5)()
        err = lib.seg_search_attrs(W, out)
        if err != 0:
            raise RuntimeError(f"seg_search attribute query failed: CUDA "
                               f"error {err} ({build.error_string(err)})")
        attrs[W] = dict(zip(("registers", "local_bytes",
                             "static_smem_bytes", "max_threads",
                             "smem_optin_bytes"), out))
    return attrs


#: :func:`wave_streams` by CUDA device index
_WAVES: dict = {}


def wave_streams(device) -> int:
    """Warp streams the card holds at once at the kernel's narrowest
    layout (SMs x its warp streams per SM): every layout holds at most
    this many, so a launch of this many histories or more fills the
    card. 0 on CPU tensors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _WAVES:
        sms = torch.cuda.get_device_properties(key).multi_processor_count
        with on_device(torch.device("cuda", key)):
            _WAVES[key] = sms * warp_streams_per_sm(spec_for(2, 2, 1, 2), 4)
    return _WAVES[key]


def default_groups(B: int, spec: SegKernelSpec, table_n: int,
                   device) -> int:
    """Group streams for a batch of ``B``: on the card, as many warp
    streams as it holds at once (SMs x warp streams per SM for this
    layout), so the whole batch runs in one wave; on CPU tensors
    ``SM_COUNT``."""
    if device.type != "cuda":
        return max(min(B, SM_COUNT), 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(min(B, sms * warp_streams_per_sm(spec, table_n)), 1)


def seg_search_stream(seg: torch.Tensor, stride: int, table: torch.Tensor,
                      spec: SegKernelSpec, n_hist: int,
                      work: Optional[torch.Tensor] = None,
                      need: Optional[torch.Tensor] = None,
                      lib=None) -> torch.Tensor:
    """Run G RESET-marked group streams ``seg`` (int32[G, L, 2+2K]) from
    the initial carry. Returns ``results`` int32[G, n_hist, 3]: the
    ``(status, fail, n)`` of each group's histories in stream order
    (fail in stream coordinates).

    CPU tensors run :func:`seg_search_reference` group by group; CUDA
    tensors launch the kernel once, one warp per group, and a failed
    build or launch raises. ``work`` and ``need`` (int64[G], CUDA only)
    receive each group's comparison counts, and ``lib`` is the library
    to launch (see :func:`_launch`)."""
    dev = seg.device
    G = seg.shape[0]
    # non-blocking uploads: a blocking copy would wait for the launches
    # already queued on the stream (the staged batch path's overlap)
    ws0 = upload(initial_frontier(spec), dev)
    stat0 = upload(_init_stat(), dev)
    results = torch.zeros((G, max(n_hist, 1), 3), dtype=torch.int32,
                          device=dev)
    if not seg.is_cuda:
        for g in range(G):
            seg_search_reference(seg[g], 0, stride, ws0, stat0, table,
                                 spec, results=results[g])
        return results
    _launch(seg, 0, stride, ws0.expand(G, *ws0.shape).contiguous(),
            stat0.expand(G, 4).contiguous(), table, spec, results=results,
            work=work, need=need, lib=lib)
    return results


def pack_groups(segs_list, spec: SegKernelSpec, groups: int, empty=None):
    """Pack histories into ``groups`` RESET-marked group streams,
    balanced by segment count (:func:`plan_groups`), each padded with
    dead rows to the longest. Returns ``(seg int32[G, L, 2+2K], plan,
    starts)``: ``plan[g]`` lists group g's history indices in stream
    order, ``starts[g]`` their first segments' stream indices.
    ``empty(shape)`` gives the int32 array ``seg`` is written into
    (default: a new NumPy array)."""
    sizes = [s.ok_proc.shape[0] for s in segs_list]
    plan = plan_groups(sizes, groups)
    L = max(sum(sizes[b] for b in grp) + len(grp) + 1 for grp in plan)
    shape = (len(plan), L, 2 + 2 * spec.K)
    seg = np.empty(shape, np.int32) if empty is None else empty(shape)
    starts = [_fill_stream(seg[g], [segs_list[b] for b in grp], spec)
              for g, grp in enumerate(plan)]
    return seg, plan, starts


class StagedStream(NamedTuple):
    """One launch queued by :func:`stream_stage`: ``fetch`` is the
    readback's finalize (the pinned copy of the results behind its
    event), ``index`` and ``starts`` put each history's row of the
    grouped results back in input order."""
    fetch: object
    index: np.ndarray      # int64[B, 2]: (group, position) of history b
    starts: np.ndarray     # int64[B]: history b's first stream row
    n: int


def stream_stage(succ, segs_list, spec: SegKernelSpec, n_states: int,
                 n_transitions: int, device=None,
                 groups: Optional[int] = None,
                 info: Optional[dict] = None) -> StagedStream:
    """Pack, upload and launch one stream-mode call WITHOUT a readback:
    the results are copied into pinned host memory behind a CUDA event
    on ``device``'s current stream (:func:`~..utils.readback_async`),
    so the host packs the next launch while this one runs. On CPU
    tensors the plain version runs here. Collect with
    :func:`stream_collect`."""
    dev = resolve_device(device)
    with on_device(dev):
        table = upload(pack_table(np.asarray(succ)[:n_states,
                                                   :n_transitions]), dev)
        if groups is None:
            groups = default_groups(len(segs_list), spec, table.numel(),
                                    dev)
        if dev.type == "cuda":
            # written straight into pinned memory (torch's host cache
            # reuses the block), then one non-blocking copy
            pinned = []

            def empty(shape):
                pinned.append(torch.empty(shape, dtype=torch.int32,
                                          pin_memory=True))
                return pinned[0].numpy()

            seg, plan, starts = pack_groups(segs_list, spec, groups,
                                            empty=empty)
            seg_dev = pinned[0].to(dev, non_blocking=True)
        else:
            seg, plan, starts = pack_groups(segs_list, spec, groups)
            seg_dev = torch.from_numpy(seg)
        n_hist = max(len(grp) for grp in plan)
        if info is not None:
            info.update(groups=len(plan), rows=seg.shape[1],
                        histories=len(segs_list), max_per_group=n_hist)
            if dev.type == "cuda":
                info["streams_per_sm"] = warp_streams_per_sm(
                    spec, table.numel())
        res = seg_search_stream(seg_dev, n_transitions, table, spec,
                                n_hist)
        fetch = readback_async(res)
    index = np.zeros((len(segs_list), 2), np.int64)
    st = np.zeros(len(segs_list), np.int64)
    for g, grp in enumerate(plan):
        index[grp, 0] = g
        index[grp, 1] = np.arange(len(grp))
        st[grp] = starts[g]
    return StagedStream(fetch, index, st, len(segs_list))


def stream_rows(staged: StagedStream):
    """Wait for one staged launch and return ``(rows int32[B, 3],
    starts int64[B])`` in input order: each history's ``(status, fail,
    n)`` with fail in its group stream's coordinates, and its first
    row in that stream (the pair :func:`merge_stream_slice` takes)."""
    res = staged.fetch()
    return res[staged.index[:, 0], staged.index[:, 1]], staged.starts


def stream_collect(staged: StagedStream):
    """``[(status, fail_seg_local, n), ...]`` of a staged launch, in
    input order."""
    rows, starts = stream_rows(staged)
    return merge_stream_slice(rows, starts, staged.n)


def stream_dispatch(succ, segs_list, spec: SegKernelSpec, n_states: int,
                    n_transitions: int, device=None,
                    groups: Optional[int] = None,
                    info: Optional[dict] = None):
    """Check many independent histories in ONE launch: pack them into
    G RESET-marked group streams balanced by segment count (G from
    :func:`default_groups` unless given), one warp per group. Every
    history gets its own verdict; one history's INVALID or UNKNOWN never
    stops the others. Returns ``[(status, fail_seg_local, n), ...]`` in
    input order; ``info`` receives the launch geometry. The staged
    pair :func:`stream_stage` / :func:`stream_collect`, back to back."""
    if not segs_list:
        return []
    return stream_collect(stream_stage(succ, segs_list, spec, n_states,
                                       n_transitions, device,
                                       groups=groups, info=info))


# --- the mesh route: one launch per device ------------------------------------

def plan_shard_slices(B: int, D: int,
                      max_stream_b: Optional[int] = None):
    """Pure slice assignment for the sharded stream path: ``B`` (a
    positive multiple of ``D`` — callers pad with sentinel histories)
    splits into ``[(start, end), ...]`` slices whose width is always a
    multiple of ``D``. Within a slice, shard ``d`` owns the contiguous
    sub-range ``[start + d*g, start + (d+1)*g)`` with ``g = (end -
    start) // D``. Per-shard slice width is capped at ``max_stream_b``
    (default: no cap — one slice)."""
    if D <= 0 or B % D != 0:
        raise ValueError(f"B={B} must be a positive multiple of D={D}")
    cap = max(B // D, 1) if max_stream_b is None else max_stream_b
    step = min(cap, max(B // D, 1)) * D
    return [(i, min(i + step, B)) for i in range(0, B, step)]


def merge_stream_shards(res, starts, n: int, D: int):
    """Pure verdict unpacking for ONE sharded dispatch: ``res[d]`` holds
    shard d's rows, ``starts[d]`` their stream offsets. Returns the
    slice's ``n`` verdicts in slice order (shard d owns the contiguous
    sub-range ``[d*g, (d+1)*g)``, matching :func:`plan_shard_slices`)."""
    g = n // D
    out = []
    for d in range(D):
        out.extend(merge_stream_slice(res[d], starts[d], g))
    return out


def stream_stage_sharded(succ, segs_list, spec: SegKernelSpec,
                         n_states: int, n_transitions: int, mesh):
    """Stage ONE launch per device of ``mesh`` (a tuple of D devices)
    for a slice of B histories, B % D == 0: shard d launches
    ``seg_search.cu`` in stream mode on ``mesh[d]``, with its own copy
    of the table, over histories ``[d*g, (d+1)*g)``, g = B / D. No
    collectives: each shard is a closed computation. Returns the D
    staged launches; collect with :func:`collect_shards`."""
    D = len(mesh)
    B = len(segs_list)
    if D <= 0 or B % D != 0:
        raise ValueError(f"B={B} must be a multiple of D={D}")
    g = B // D
    return [stream_stage(succ, segs_list[d * g:(d + 1) * g], spec,
                         n_states, n_transitions, mesh[d])
            for d in range(D)]


def collect_shards(staged):
    """Wait for every shard's launch: ``(res int32[D, g, 3], starts
    [D][g])``, the pair :func:`merge_stream_shards` decodes."""
    rows = [stream_rows(s) for s in staged]
    return np.stack([r for r, _ in rows]), [st for _, st in rows]


def stream_dispatch_sharded(succ, segs_list, spec: SegKernelSpec,
                            n_states: int, n_transitions: int, mesh):
    """The sharded launch of B histories over ``mesh``, staged and
    collected: returns ``(res, starts)`` for
    :func:`merge_stream_shards` (see :func:`stream_stage_sharded`)."""
    return collect_shards(stream_stage_sharded(
        succ, segs_list, spec, n_states, n_transitions, mesh))
