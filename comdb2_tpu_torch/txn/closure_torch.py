"""Device cycle engine — boolean transitive closure on the tensor cores.

The counterpart of the JAX package's ``txn/closure_jax.py``. Cycle
detection over a txn dependency graph is matmul-shaped: with A the
adjacency matrix, ``A+ = A | A^2 | A^4 | ...`` converges in
ceil(log2 N) squarings, and a vertex is on a cycle iff ``A+[v, v]``.
All three Adya layers ride one ``(3, N, N)`` stack, so one call
classifies G0 / G1c / G2-item with a fixed number of matmuls and one
readback, never a per-edge or per-layer device round trip.

Exactness on cuBLAS. Each squaring is ``torch.matmul`` on bf16 0/1
operands, then ``g | (sq > 0)``. Every product and every partial sum
is a non-negative integer, and a positive count rounds to a positive
bf16 (the least is 1, far above bf16's smallest normal; the largest is
N <= 65536, far below its overflow), so whatever order, width or
precision cuBLAS reduces in — f32 accumulation, reduced-precision bf16
reduction, a bf16 output — a reachable pair can never read 0 and an
unreachable one never reads more. The result does not depend on
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
so it is right whichever module set that flag first.

Upload: the planes travel PACKED, ``np.packbits`` on the host (8x
smaller: 8 MB instead of 64 MB at N = 4096) and unpacked on the card
(:func:`_unpack_bits`), as in the JAX package. The only readback is
the ``(3, N)`` (or ``(B, 3, N)``) diagonal. N is pow2-bucketed with a
floor of ``edges.TXN_N_FLOOR``; pad rows and columns carry no edge, so
they are inert under closure and read False.

Staged: :func:`closure_diag_batch_async` queues the upload (through
pinned memory), the squarings and a non-blocking copy of the diagonal
into pinned host memory behind a CUDA event, and its ``finalize`` waits
on that event alone. The mesh route (``mesh=``, a tuple of D devices)
splits the batch axis D ways, pads it with all-zero graphs to a power of
two at least D, and makes one independent call per device — no
collectives; D = 1 is the single-device call on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import (next_pow2, on_device, readback_async,
                     resolve_device, upload)

#: device calls of the closure (one per ``closure_diag`` or batch);
#: tests and ``chip_smoke.py`` hold the single-call rule against it
DISPATCHES = 0


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N/8) uint8 -> (..., N) bool on the tensor's device
    (``np.packbits`` is MSB-first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], n).bool()


def _closure_step(g: torch.Tensor) -> torch.Tensor:
    """One squaring: ``g | g.g`` over (..., 3, N, N) bool — bf16 matmul,
    exact for 0/1 operands (module docstring)."""
    gb = g.to(torch.bfloat16)
    return g | (torch.matmul(gb, gb) > 0)


def _build_layers(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4, N, N/8) packed planes -> (..., 3, N, N) cumulative Adya
    layers (ww; ww|wr; ww|wr|rw), the rt plane OR-ed into every layer
    (it is shipped all-zero when realtime is off)."""
    a = _unpack_bits(planes, n)                       # (..., 4, N, N)
    ww, wr, rw, rt = (a[..., i, :, :] for i in range(4))
    l0 = ww | rt
    l1 = l0 | wr
    l2 = l1 | rw
    return torch.stack([l0, l1, l2], dim=-3)


def squarings(n: int) -> int:
    """ceil(log2 n) squarings reach the full closure (at least one)."""
    return max(1, (n - 1).bit_length())


def _diag_kernel(planes: torch.Tensor, n: int) -> torch.Tensor:
    g = _build_layers(planes, n)
    for _ in range(squarings(n)):
        g = _closure_step(g)
    return torch.diagonal(g, dim1=-2, dim2=-1)        # (..., 3, N)


def _pack(adj: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(adj, bool), axis=-1)


def _launch(adj: np.ndarray, device) -> torch.Tensor:
    """Upload the packed planes and queue the squarings; returns the
    diagonal on the card (no synchronise)."""
    global DISPATCHES
    dev = resolve_device(device)
    n = adj.shape[-1]
    if n % 8:
        raise ValueError(f"closure N must be a multiple of 8, got {n}")
    with on_device(dev):
        out = _diag_kernel(upload(_pack(adj), dev), n)
    DISPATCHES += 1
    return out


def closure_diag(adj: np.ndarray, device=None) -> np.ndarray:
    """(4, N, N) bool planes -> (3, N) bool per-layer cyclic-vertex
    mask. One device call; N must be a power of two (use
    ``TxnGraph.padded``). ``device``: ``None`` means ``cuda``."""
    return _launch(adj, device).cpu().numpy()


def closure_diag_batch(adjs: np.ndarray, mesh=None,
                       device=None) -> np.ndarray:
    """(B, 4, N, N) bool -> (B, 3, N) bool, one device call for the
    whole batch. All-zero pad graphs (the caller's pow2 batch padding)
    are acyclic and read all False."""
    return closure_diag_batch_async(adjs, mesh=mesh, device=device)()


def closure_diag_batch_async(adjs: np.ndarray, mesh=None, device=None):
    """Stage the batched closure and return a zero-argument
    ``finalize()`` producing the (B, 3, N) diagonal mask: the upload, the
    squarings and the copy of the diagonal to pinned host memory are
    queued on the card here, and ``finalize`` waits on the copy's event.

    ``mesh``: a tuple of D devices (``service.sharding.make_mesh``),
    ``device`` then unused. D must be a power of two; for D > 1 the
    batch pads with all-zero graphs to ``max(next_pow2(B), D)`` and
    shard d's graphs go through one call on ``mesh[d]``; the pads are
    sliced off."""
    if mesh is None:
        return readback_async(_launch(adjs, device))
    D = len(mesh)
    if D < 1 or D & (D - 1):
        raise ValueError(f"mesh size must be a power of two (got {D}) — "
                         "per-shard shapes must stay pow2")
    if D == 1:
        return closure_diag_batch_async(adjs, device=mesh[0])
    B = adjs.shape[0]
    b_pad = max(next_pow2(B), D)
    if b_pad != B:
        pad = np.zeros((b_pad - B,) + adjs.shape[1:], adjs.dtype)
        adjs = np.concatenate([adjs, pad])
    g = b_pad // D
    fins = [closure_diag_batch_async(adjs[d * g:(d + 1) * g],
                                     device=mesh[d]) for d in range(D)]
    return lambda: np.concatenate([f() for f in fins])[:B]


def cyclic_layers_device(adj: np.ndarray, realtime: bool = False,
                         device=None) -> np.ndarray:
    """Device twin of :func:`.scc.cyclic_layers_host` over UNPADDED
    (4, n, n) planes: pads to the bucket, zeroes rt when realtime is
    off, and trims the answer back to n."""
    from .edges import TXN_N_FLOOR

    n = adj.shape[-1]
    np2 = next_pow2(max(n, 1), TXN_N_FLOOR)
    padded = np.zeros((4, np2, np2), dtype=bool)
    padded[:, :n, :n] = adj
    if not realtime:
        padded[3] = False
    return closure_diag(padded, device=device)[:, :n]


__all__ = ["DISPATCHES", "closure_diag", "closure_diag_batch",
           "closure_diag_batch_async", "cyclic_layers_device",
           "squarings"]
