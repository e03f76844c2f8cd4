"""Segment-search kernel: the whole segment loop of one history in one
CUDA launch.

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
closure iteration x bitonic stage, each stage a block-wide barrier.
The design keeps that chain short: one CTA per history holds the
frontier, its candidates and the successor table in shared memory for
the whole run (no device-memory round trip between segments), and
each closure iteration sorts only ``next_pow2(n * (P + 1))`` keys — the
frontier that is actually live — instead of the full buffer.

Host half (same key layout as the JAX package, so frontiers decode
identically): :class:`SegKernelSpec`, :func:`spec_for`,
:func:`pack_table`, :func:`pack_segments`, :func:`initial_frontier`,
:func:`decode_frontier`. The plain PyTorch version is
:func:`seg_search_reference`; :func:`seg_search` runs it only for CPU
tensors and launches the CUDA kernel (``kernels/seg_search.cu``) for
CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..obs import trace as _obs
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device
from .linear_torch import INVALID, UNKNOWN, VALID

LANES = 128
F = LANES                 # frontier capacity
CHUNK = 1024              # segments per launch on the chunked path
MAX_TABLE = 8192          # successor-table entries the kernel serves
MAX_K = 8                 # invokes per segment the kernel serves

SENT_HI = 1 << 30
SENT_LO = 0

#: kernel launches this process (the wrapper's count; the plain
#: version never touches it)
LAUNCHES = 0


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
        """Sort-buffer capacity: frontier plus P candidate blocks,
        padded to a power of two."""
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
                         work: Optional[dict] = None):
    """The segment search as a set-semantics loop of torch ops, on the
    inputs' device. Same contract as :func:`seg_search`: returns
    ``(status, fail, n, ws_out)`` with ``ws_out`` int32[n_words, 128]
    (survivors first, sentinel after).

    ``work``, when given, accumulates what the kernel's algorithm must
    do on these inputs: ``keys`` (keys dedup'd over all closure
    iterations) and ``compare_exchanges`` (bitonic compare-exchanges
    over each iteration's ``next_pow2(n * (P + 1))`` keys) — the
    operation count of the kernel's roofline bound."""
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

    for i, row in enumerate(seg.tolist()):
        if status != VALID:
            break
        okp, depth = row[0], row[1]
        if okp < 0:
            continue
        for k in range(K):
            p, tr = row[2 + k], row[2 + K + k]
            if 0 <= p < P:
                fr = fr + (tr + 1) * slot_unit[p]
        ovf = False
        n = fr.shape[0]
        for _ in range(depth):
            if work is not None:
                m = _next_pow2(n * (P + 1))
                lg = m.bit_length() - 1
                work["keys"] = work.get("keys", 0) + n * (P + 1)
                work["compare_exchanges"] = (
                    work.get("compare_exchanges", 0)
                    + (m // 2) * lg * (lg + 1) // 2)
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

def _check_inputs(seg, ws, stat, table, spec: SegKernelSpec) -> None:
    dev = ws.device
    for name, t in (("seg", seg), ("ws", ws), ("stat", stat),
                    ("table", table)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, ws on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.dim() != 2 or seg.shape[1] != 2 + 2 * spec.K:
        raise ValueError(f"seg shape {tuple(seg.shape)} != (S, "
                         f"{2 + 2 * spec.K})")
    if tuple(ws.shape) != (spec.n_words, LANES):
        raise ValueError(f"ws shape {tuple(ws.shape)} != "
                         f"({spec.n_words}, {LANES})")
    if tuple(stat.shape) != (4,):
        raise ValueError(f"stat shape {tuple(stat.shape)} != (4,)")
    if table.dim() != 1 or not 0 < table.numel() <= MAX_TABLE:
        raise ValueError(f"table must be 1-D with 1..{MAX_TABLE} "
                         f"entries, got {tuple(table.shape)}")


def _launch(seg, off: int, stride: int, ws, stat, table,
            spec: SegKernelSpec):
    """One kernel launch on the current stream; returns the output
    carry ``(ws_out, stat_out)`` without synchronising."""
    global LAUNCHES
    from ..kernels import build

    lib = build.load()
    _check_inputs(seg, ws, stat, table, spec)
    ws_out = torch.empty_like(ws)
    stat_out = torch.empty_like(stat)
    lay = build.layout(spec)
    err = lib.seg_search_launch(
        seg.data_ptr(), seg.shape[0], off, stride, ws.data_ptr(),
        stat.data_ptr(), table.data_ptr(), table.numel(),
        ws_out.data_ptr(), stat_out.data_ptr(), 1, ctypes.byref(lay),
        torch.cuda.current_stream(ws.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_search launch failed: CUDA error {err} "
                           f"({build.error_string(err)})")
    LAUNCHES += 1
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
