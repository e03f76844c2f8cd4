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
independent. The CUDA kernel (``kernels/pair_sort.cu``) runs a bitonic
network: a row of at most ``SMEM_N`` pairs sorts in one CTA's shared
memory; a wider row sorts ``SMEM_N``-pair tiles in shared memory, then
takes one global-memory launch per merge stage whose partner distance
is a tile or more and finishes each merge in shared memory. What bounds
it on the card: bytes for a single pass, but the network makes
``log2(N)·(log2(N)+1)/2`` passes over the row, all in shared memory
below ``SMEM_N`` — see ``PERF.md`` for its times against the bound.

:func:`pair_sort_reference` is the plain version (two stable torch
sorts); :func:`pair_sort` runs it for CPU tensors and launches the
kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

#: pairs a row may have to sort in one CTA's shared memory (64 KB)
SMEM_N = 8192

#: kernel launches this process — one per :func:`pair_sort` call on
#: the card (a row wider than ``SMEM_N`` takes several grid launches
#: inside that one call)
LAUNCHES = 0


def pair_sort_reference(hi: torch.Tensor, lo: torch.Tensor):
    """The plain version: a stable sort on ``hi`` after a stable sort on
    ``lo``, row by row. Returns ``(hi_sorted, lo_sorted)``."""
    i1 = torch.sort(lo, dim=1, stable=True).indices
    h1 = torch.gather(hi, 1, i1)
    i2 = torch.sort(h1, dim=1, stable=True).indices
    order = torch.gather(i1, 1, i2)
    return torch.gather(hi, 1, order), torch.gather(lo, 1, order)


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


def pair_sort(hi: torch.Tensor, lo: torch.Tensor):
    """Sort each row of ``(hi, lo)`` (int32 ``(B, N)``, N a power of
    two) ascending lexicographically. Returns new tensors.

    CPU tensors run :func:`pair_sort_reference`; CUDA tensors launch
    the kernel on the current stream, and a failed build or launch
    raises."""
    _check_inputs(hi, lo)
    if not hi.is_cuda:
        return pair_sort_reference(hi, lo)
    global LAUNCHES
    from ..kernels import build

    lib = build.load("pair_sort")
    out_hi = hi.clone()
    out_lo = lo.clone()
    B, N = hi.shape
    if B:
        err = lib.pair_sort_launch(
            out_hi.data_ptr(), out_lo.data_ptr(), B, N, SMEM_N,
            torch.cuda.current_stream(hi.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pair_sort launch failed: CUDA error {err} "
                               f"({build.error_string(err, 'pair_sort')})")
        LAUNCHES += 1
    return out_hi, out_lo


__all__ = ["LAUNCHES", "SMEM_N", "pair_sort", "pair_sort_reference"]
