"""Pair sort: each row of ``(hi, lo)`` int32 pairs sorted ascending,
lexicographically, comparing signed words with ``hi`` first.

Replaces the JAX package's Pallas kernel
``comdb2_tpu/checker/pallas_sort.py`` ``_bitonic_kernel`` (launched by
``sort_pairs``). There its only caller, the opt-in branch of
``linear_jax._k_dedup``, needs a power-of-two block width that the
batch path never produces, so the TPU kernel never runs there; in the
port it is the keys engine's per-batch block sort
(:func:`~.linear_torch._k_dedup`), each block padded to the next
power of two with that block's own sentinel.

Shapes: ``(B, N)`` int32 twice, N a power of two; rows are
independent. The CUDA kernel (``kernels/pair_sort.cu``) sorts one
64-bit key per pair, ``((hi ^ 2^31) << 32) | (lo ^ 2^31)``, whose
unsigned order is the pairs' signed lexicographic order (equal keys are
equal pairs, so the sort's order is the stable one). A block-sort launch
sorts tiles of
``SMEM_N`` keys (16 per thread in registers, a bitonic network in
registers, shuffles and shared memory); a row of at most ``SMEM_N``
pairs is then done. A wider row takes ``log2(N / SMEM_N)`` merge passes,
each one launch of ``B * N / SMEM_N`` CTAs that split the merged runs on
the merge-path diagonal. What bounds it on the card: bytes, one read and
one write of 16 bytes per pair, against ``1 + log2(N / SMEM_N)`` passes
over the rows (which stay in L2 between passes at the keys engine's
sizes) — see ``PERF.md`` for its times against the bound.

:func:`pair_sort_reference` is the plain version (two stable torch
sorts); :func:`pair_sort` runs it for CPU tensors and launches the
kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

#: keys a CTA sorts in the block sort, and the outputs a CTA writes in a
#: merge pass (the kernel's T = 16 keys x 256 threads; 34,816 bytes of
#: shared memory per CTA)
SMEM_N = 4096

#: kernel launches this process — one per :func:`pair_sort` call on
#: the card (:func:`launches_per_call` grid launches inside that one call)
LAUNCHES = 0


def pair_sort_reference(hi: torch.Tensor, lo: torch.Tensor):
    """The plain version: a stable sort on ``hi`` after a stable sort on
    ``lo``, row by row. Returns ``(hi_sorted, lo_sorted)``."""
    i1 = torch.sort(lo, dim=1, stable=True).indices
    h1 = torch.gather(hi, 1, i1)
    i2 = torch.sort(h1, dim=1, stable=True).indices
    order = torch.gather(i1, 1, i2)
    return torch.gather(hi, 1, order), torch.gather(lo, 1, order)


def launches_per_call(N: int, tile: int = SMEM_N) -> int:
    """Grid launches of one sort of rows of N pairs: the block sort,
    then one merge pass per doubling from ``tile`` to N."""
    return 1 + max(N // tile, 1).bit_length() - 1


def _check_inputs(hi: torch.Tensor, lo: torch.Tensor) -> None:
    if hi.device != lo.device:
        raise ValueError(f"hi on {hi.device}, lo on {lo.device}")
    for name, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (B, N), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hi.shape != lo.shape:
        raise ValueError(f"hi {tuple(hi.shape)} != lo {tuple(lo.shape)}")
    N = hi.shape[1]
    if N < 1 or N & (N - 1):
        raise ValueError(f"row width {N} is not a power of two")


def _buffers(lib, hi, lo):
    """Inputs at 16-byte alignment, new outputs and the scratch the
    kernel needs."""
    B, N = hi.shape
    hi, lo = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (hi, lo))
    scratch = torch.empty(lib.pair_sort_scratch_words(B, N),
                          dtype=torch.int64, device=hi.device)
    return hi, lo, torch.empty_like(hi), torch.empty_like(lo), scratch


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        from ..kernels import build

        raise RuntimeError(f"pair_sort {what} failed: CUDA error {err} "
                           f"({build.error_string(err, 'pair_sort')})")


def pair_sort(hi: torch.Tensor, lo: torch.Tensor, lib=None):
    """Sort each row of ``(hi, lo)`` (int32 ``(B, N)``, N a power of
    two) ascending lexicographically. Returns new tensors.

    CPU tensors run :func:`pair_sort_reference`; CUDA tensors launch
    the kernel on the current stream (``lib``: a library from
    ``kernels.build.load("pair_sort", defines)``, else the plain build),
    and a failed build or launch raises."""
    _check_inputs(hi, lo)
    if not hi.is_cuda:
        return pair_sort_reference(hi, lo)
    global LAUNCHES
    from ..kernels import build

    lib = build.load("pair_sort") if lib is None else lib
    B, N = hi.shape
    if not B:
        return hi.clone(), lo.clone()
    hi, lo, out_hi, out_lo, scratch = _buffers(lib, hi, lo)
    _raise_on(lib.pair_sort_launch(
        hi.data_ptr(), lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
        scratch.data_ptr(), B, N,
        torch.cuda.current_stream(hi.device).cuda_stream), "launch")
    LAUNCHES += 1
    return out_hi, out_lo


def phase_ms(hi: torch.Tensor, lo: torch.Tensor, reps: int = 20):
    """Milliseconds of each grid launch of one sort of the CUDA tensors
    ``(hi, lo)``: ``[block sort, merge pass 1, ...]``, each the mean over
    ``reps`` sorts of CUDA events recorded around that launch alone. A
    warm-up sort first; then a sleep kernel holds the card while the host
    queues the sorts, so that the host's launch time does not show. A
    timing call: it checks nothing of the result."""
    global LAUNCHES
    from ..kernels import build

    _check_inputs(hi, lo)
    lib = build.load("pair_sort")
    B, N = hi.shape
    hi, lo, out_hi, out_lo, scratch = _buffers(lib, hi, lo)
    stream = torch.cuda.current_stream(hi.device)
    n = launches_per_call(N, lib.pair_sort_tile())
    args = (hi.data_ptr(), lo.data_ptr(), out_hi.data_ptr(),
            out_lo.data_ptr(), scratch.data_ptr(), B, N)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
              for _ in range(reps)]
    _raise_on(lib.pair_sort_launch(*args, stream.cuda_stream), "launch")
    LAUNCHES += 1
    torch.cuda.synchronize(hi.device)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(reps * n * 200_000)
    for ev in events:
        ev[0].record(stream)
        for p in range(n):
            _raise_on(lib.pair_sort_phase(*args, p, stream.cuda_stream),
                      f"phase {p}")
            ev[p + 1].record(stream)
        LAUNCHES += 1
    torch.cuda.synchronize(hi.device)
    return [sum(ev[p].elapsed_time(ev[p + 1]) for ev in events) / reps
            for p in range(n)]


def kernel_attrs(lib=None):
    """What the loaded library's kernels were compiled to, read from the
    library itself (so the same on a fresh or a cached build): ``{"block":
    {...}, "merge": {...}}``, each with ``registers`` per thread,
    ``local_bytes`` (spills) per thread and ``static_smem_bytes`` per
    CTA."""
    import ctypes

    from ..kernels import build

    lib = build.load("pair_sort") if lib is None else lib
    attrs = {}
    for phase, name in enumerate(("block", "merge")):
        out = (ctypes.c_int * 3)()
        _raise_on(lib.pair_sort_attrs(phase, out), "attribute query")
        attrs[name] = dict(zip(("registers", "local_bytes",
                                "static_smem_bytes"), out))
    return attrs


__all__ = ["LAUNCHES", "SMEM_N", "kernel_attrs", "launches_per_call",
           "pair_sort", "pair_sort_reference", "phase_ms"]
