"""The pair sort (``checker/pair_sort.py``): per-row ascending
lexicographic sort of ``(hi, lo)`` int32 pairs, signed words, ``hi``
first.

- The plain version (what the wrapper runs for CPU tensors) against
  ``np.lexsort`` on rows with negative words, duplicates and the keys
  engine's block sentinels. Exact.
- The CUDA kernel's stage schedule (``kernels/pair_sort.cu``: shared-
  memory tiles, one global pass per wide merge distance, the direction
  of each compare-exchange from the pair's index in its row) replayed
  in numpy at a small tile width, against ``np.lexsort``. The kernel
  itself runs only on the card (``test_torch_cuda.py``).
- The wrapper's input checks.
"""

import numpy as np
import pytest
import torch

from comdb2_tpu_torch.checker.pair_sort import (SMEM_N, pair_sort,
                                                pair_sort_reference)


def _rows(seed, B, N, lo_range=(-2**31, 2**31 - 1)):
    rng = np.random.default_rng(seed)
    hi = rng.integers(-4, 4, (B, N)).astype(np.int32)       # duplicates
    lo = rng.integers(*lo_range, (B, N), dtype=np.int64).astype(np.int32)
    # the keys engine's block sentinel, and exact duplicate pairs
    hi[:, :N // 8] = 1 << 30
    lo[:, :N // 8] = 1 << 29
    hi[:, N // 2:N // 2 + N // 8] = hi[:, :N // 8][:, ::-1] - 1
    lo[:, -3:] = np.iinfo(np.int32).min
    return hi, lo


def _lexsorted(hi, lo):
    out_h = np.empty_like(hi)
    out_l = np.empty_like(lo)
    for b in range(hi.shape[0]):
        o = np.lexsort((lo[b], hi[b]))
        out_h[b], out_l[b] = hi[b][o], lo[b][o]
    return out_h, out_l


@pytest.mark.parametrize("B,N", [(1, 1), (3, 2), (4, 64), (2, 4096),
                                 (2, 2 * SMEM_N)])
def test_plain_version_matches_lexsort(B, N):
    hi, lo = _rows(B * N, B, N)
    got = pair_sort(torch.from_numpy(hi), torch.from_numpy(lo))
    want = _lexsorted(hi, lo)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    ref = pair_sort_reference(torch.from_numpy(hi), torch.from_numpy(lo))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _kernel_schedule(hi, lo, smem_n):
    """The kernel's stages in numpy: ``pair_sort_tile`` over each
    ``T``-pair tile for k = 2..T, then per merge k > T one global pass
    per distance j >= T and a tile pass for j < T."""
    h = hi.copy()
    l = lo.copy()
    B, N = h.shape
    T = min(N, smem_n)

    def stage(k, j, idx):
        i = ((idx & ~(j - 1)) << 1) | (idx & (j - 1))
        m = i + j
        asc = (i & k) == 0
        ah, al, bh, bl = h[:, i], l[:, i], h[:, m], l[:, m]
        swap = ((bh < ah) | ((bh == ah) & (bl < al))) == asc[None, :]
        h[:, i], h[:, m] = np.where(swap, bh, ah), np.where(swap, ah, bh)
        l[:, i], l[:, m] = np.where(swap, bl, al), np.where(swap, al, bl)

    pairs = np.arange(N // 2)

    def tile_pass(k_lo, k_hi):
        # every tile of every row at once: a tile's pairs are the row's
        # pairs whose both elements fall in that tile (j < T)
        k = k_lo
        while k <= k_hi:
            j = min(k, T) >> 1
            while j > 0:
                stage(k, j, pairs)
                j >>= 1
            k <<= 1

    if N > 1:
        tile_pass(2, T)
        k = 2 * T
        while k <= N:
            j = k >> 1
            while j >= T:
                stage(k, j, pairs)
                j >>= 1
            tile_pass(k, k)
            k <<= 1
    return h, l


@pytest.mark.parametrize("B,N,smem_n", [(2, 64, 64), (2, 256, 16),
                                        (3, 1024, 64), (1, 8, 2),
                                        (2, 2, 16)])
def test_kernel_schedule_sorts(B, N, smem_n):
    hi, lo = _rows(N + smem_n, B, N)
    got = _kernel_schedule(hi, lo, smem_n)
    want = _lexsorted(hi, lo)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        pair_sort(z[:, :6].contiguous(), z[:, :6].contiguous())
    with pytest.raises(TypeError):
        pair_sort(z.long(), z)
    with pytest.raises(ValueError):
        pair_sort(z, z[:1])
    with pytest.raises(ValueError):
        pair_sort(z[:, ::2], z[:, ::2])
