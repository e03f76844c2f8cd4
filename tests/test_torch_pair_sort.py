"""The pair sort (``checker/pair_sort.py``): per-row ascending
lexicographic sort of ``(hi, lo)`` int32 pairs, signed words, ``hi``
first.

- The plain version (what the wrapper runs for CPU tensors) against
  ``np.lexsort`` on rows with negative words, duplicates and the keys
  engine's block sentinels. Exact.
- The CUDA kernel's schedule (``kernels/pair_sort.cu``) replayed in
  numpy at small tiles, against ``np.lexsort``: the 64-bit key
  transform; the block sort's registers ``v[t, e]`` and its stages in
  registers, across lanes and in shared memory; each merge pass's
  co-rank split of a slice, per-thread sub-diagonals and branch-free
  serial merge. Rows: random, all equal, corner words, sentinel tails,
  presorted, reversed, one run exhausted before the other; N below, at
  and above the tile. The key transform on every pair of corner words;
  the co-rank search against the merge-path conditions. The kernel
  itself runs only on the card (``test_torch_cuda.py``).
- The wrapper's input checks.
"""

import numpy as np
import pytest
import torch

from comdb2_tpu_torch.checker.pair_sort import (SMEM_N, launches_per_call,
                                                pair_sort,
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


U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def to_key(hi, lo):
    """The kernel's key of each pair (``to_key`` in ``pair_sort.cu``) as
    numpy ``uint64``: both words' sign bits flipped, ``hi`` in the upper
    half."""
    h = np.asarray(hi).astype(np.int64).astype(np.uint64) & 0xFFFFFFFF
    lw = np.asarray(lo).astype(np.int64).astype(np.uint64) & 0xFFFFFFFF
    return ((h ^ 0x80000000) << np.uint64(32)) | (lw ^ 0x80000000)


def _from_key(k):
    h = ((k >> np.uint64(32)) ^ np.uint64(0x80000000)).astype(np.uint32)
    l = ((k & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x80000000)).astype(
        np.uint32)
    return h.view(np.int32), l.view(np.int32)


def _cx(a, b, desc):
    """Compare-exchange of key arrays: ascending, descending where
    ``desc``."""
    swap = (a > b) != desc
    return np.where(swap, b, a), np.where(swap, a, b)


def _block_sort(keys, N, E, threads, warp):
    """``pair_sort_block`` in numpy: every tile of T = E * threads keys
    as ``v[t, e]`` (thread t's register e, tile position t E + e), the
    bitonic network over units of U = min(N, T) keys — stages at partner
    distance j >= warp E on the tile in shared memory, E <= j < warp E as
    lane exchanges (lane ^ j / E), j < E between a thread's registers;
    level k sorts descending where a position's bit k is set, except at
    k = U."""
    T = E * threads
    U = min(N, T)
    out = np.empty_like(keys)
    tid = np.arange(threads)
    lane = tid % warp
    for base in range(0, keys.size, T):
        tile = np.full(T, U64_MAX)
        real = min(T, keys.size - base)
        tile[:real] = keys[base:base + real]
        v = tile.reshape(threads, E).copy()
        k = 2
        while k <= U:
            km = k & (U - 1)
            if (k >> 1) >= warp * E:
                s = v.reshape(-1).copy()
                j = k >> 1
                while j >= warp * E:
                    p = np.arange(T // 2)
                    i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
                    s[i], s[i + j] = _cx(s[i], s[i + j], (i & km) != 0)
                    j >>= 1
                v = s.reshape(threads, E)
            desc = ((tid * E) & km) != 0
            m = min(k >> 1, (warp // 2) * E) // E
            while m >= 1:
                keep_min = ((lane & m) == 0) != desc
                o = v[tid ^ m]
                v = np.where((keep_min[:, None] == (o < v)), o, v)
                m >>= 1
            j = E // 2
            while j > 0:
                if j < k:
                    for e in range(E):
                        if e & j == 0:
                            v[:, e], v[:, e + j] = _cx(
                                v[:, e], v[:, e + j],
                                ((tid * E + e) & km) != 0)
                j >>= 1
            k <<= 1
        out[base:base + real] = v.reshape(-1)[:real]
    return out


def _corank_warp(a, b, L, d, lanes=32):
    """``corank_warp``: the number of a's keys among the first d outputs
    of merging a[0, L) and b[0, L), by probes of all lanes at once that
    narrow the range (lanes + 1)-fold per step."""
    lo, hi = max(0, d - L), min(d, L)
    while hi - lo > lanes:
        n = hi - lo
        q = lo + ((np.arange(lanes) + 1) * n) // (lanes + 1)
        past = a[q] > b[d - 1 - q]
        f = int((~past).sum())
        assert not past[:f].any() and past[f:].all()       # monotone
        new_lo = lo if f == 0 else lo + (f * n) // (lanes + 1) + 1
        hi = hi if f == lanes else lo + ((f + 1) * n) // (lanes + 1)
        lo = new_lo
    q = lo + np.arange(lanes)
    inside = q < hi
    qi = np.where(inside, q, 0)            # lanes past hi load nothing
    past = a[qi.clip(0, L - 1)] > b[(d - 1 - qi).clip(0, L - 1)]
    before = inside & ~past
    return lo + int(before.sum())


def _merge_pass(src, N, L, E, threads):
    """``pair_sort_merge``: each slice of C = E * threads outputs from
    its two windows, split at the co-ranks of its ends; each thread's E
    outputs from its own sub-diagonal by the branch-free serial merge."""
    C = E * threads
    dst = np.empty_like(src)
    for g0 in range(0, src.size, C):
        row, o = divmod(g0, N)
        d0 = o & (2 * L - 1)
        a = src[row * N + o - d0:][:L]
        b = src[row * N + o - d0 + L:][:L]
        i0, i1 = (_corank_warp(a, b, L, d) for d in (d0, d0 + C))
        na, j0 = i1 - i0, d0 - i0
        s = np.zeros(C, dtype=np.uint64)
        s[:na] = a[i0:i1]
        s[na:C] = b[j0:j0 + C - na]
        for t in range(threads):
            dt = t * E
            lo, hi = max(0, dt - (C - na)), min(dt, na)
            while lo < hi:
                mid = (lo + hi) >> 1
                past = s[mid] > s[na + dt - 1 - mid]
                lo, hi = (lo, mid) if past else (mid + 1, hi)
            # branch-free serial merge; a read past b's end is clamped
            # and not used
            i, j = lo, na + dt - lo
            x, y = s[i], s[min(j, C - 1)]
            for e in range(E):
                take_a = j >= C or (i < na and x <= y)
                dst[g0 + dt + e] = x if take_a else y
                i, j = i + take_a, j + (not take_a)
                z = s[min(i if take_a else j, C - 1)]
                x, y = (z, y) if take_a else (x, z)
    return dst


def _kernel_schedule(hi, lo, E, threads, warp):
    """The kernel's launches in numpy: the key transform, the block sort,
    then merge passes at L = T, 2T, ... < N; keys back to words."""
    B, N = hi.shape
    keys = to_key(hi, lo).reshape(-1)
    keys = _block_sort(keys, N, E, threads, warp)
    L, passes = E * threads, 1
    while L < N:
        keys = _merge_pass(keys, N, L, E, threads)
        L, passes = 2 * L, passes + 1
    assert passes == launches_per_call(N, E * threads)
    h, l = _from_key(keys)
    return h.reshape(B, N), l.reshape(B, N)


def _edge_rows(kind, seed, B, N):
    """Rows that take the schedule's corners."""
    rng = np.random.default_rng(seed)
    imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if kind == "random":
        return _rows(seed, B, N)
    if kind == "equal":
        return (np.full((B, N), -3, np.int32), np.full((B, N), imin,
                                                       np.int32))
    corners = np.array([imin, imin + 1, -1, 0, 1, imax - 1, imax], np.int32)
    if kind == "corners":
        return (rng.choice(corners, (B, N)).astype(np.int32),
                rng.choice(corners, (B, N)).astype(np.int32))
    hi, lo = _rows(seed, B, N)
    if kind == "sentinel_tail":           # the keys engine's padding
        hi[:, N // 2:] = 1 << 30
        lo[:, N // 2:] = 1 << 29
    elif kind in ("presorted", "reversed"):
        hi, lo = _lexsorted(hi, lo)
        if kind == "reversed":
            hi, lo = hi[:, ::-1].copy(), lo[:, ::-1].copy()
    elif kind == "run_exhausted":         # each half above the other
        hi[:, :N // 2] = rng.integers(100, 200, (B, N // 2))
        hi[:, N // 2:] = rng.integers(-200, -100, (B, N - N // 2))
    return hi, lo


# (B, N, E, threads, warp, rows): the old schedule's five shapes (tile
# 64, 16, 64, 4, 16), then each corner at N = T, N = 2T and wider
SCHEDULE_CASES = [
    (2, 64, 4, 16, 4, "random"), (2, 256, 4, 4, 4, "random"),
    (3, 1024, 4, 16, 4, "random"), (1, 8, 4, 1, 1, "random"),
    (2, 2, 4, 4, 4, "random"), (3, 8, 4, 16, 4, "random"),
    (5, 64, 4, 16, 4, "equal"), (2, 256, 4, 16, 4, "equal"),
    (2, 512, 4, 16, 4, "run_exhausted"), (3, 128, 4, 16, 4, "corners"),
    (2, 1024, 8, 8, 4, "corners"), (2, 512, 4, 16, 4, "sentinel_tail"),
    (2, 256, 4, 16, 4, "presorted"), (2, 256, 4, 16, 4, "reversed"),
    (2, 1024, 8, 16, 8, "reversed"), (4, 64, 4, 16, 4, "reversed"),
    (1, 128, 4, 16, 4, "run_exhausted"), (7, 16, 4, 16, 4, "corners"),
]


@pytest.mark.parametrize("B,N,E,threads,warp,rows", SCHEDULE_CASES)
def test_kernel_schedule_sorts(B, N, E, threads, warp, rows):
    hi, lo = _edge_rows(rows, B * N + E, B, N)
    got = _kernel_schedule(hi, lo, E, threads, warp)
    want = _lexsorted(hi, lo)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


ROW_KINDS = ("random", "equal", "corners", "sentinel_tail", "presorted",
             "reversed", "run_exhausted")


# every kind of row at each width against a tile of T = 64 (E = 4, 16
# threads, 4-lane warps, so every stage kind runs): four rows to a tile,
# one tile, two tiles (one merge pass), eight tiles (three merge passes)
@pytest.mark.parametrize("rows", ROW_KINDS)
@pytest.mark.parametrize("B,N", [(6, 16), (3, 64), (2, 128), (2, 512)])
def test_kernel_schedule_corners(B, N, rows):
    hi, lo = _edge_rows(rows, 7 * N + B, B, N)
    got = _kernel_schedule(hi, lo, 4, 16, 4)
    want = _lexsorted(hi, lo)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("rows", ROW_KINDS)
@pytest.mark.parametrize("B,N", [(3, 256), (2, 2 * SMEM_N)])
def test_plain_version_on_corner_rows(B, N, rows):
    hi, lo = _edge_rows(rows, B * N, B, N)
    got = pair_sort(torch.from_numpy(hi), torch.from_numpy(lo))
    want = _lexsorted(hi, lo)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


def test_key_transform_orders_corner_words_as_lexsort():
    w = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).min + 1, -2,
                  -1, 0, 1, 2, np.iinfo(np.int32).max - 1,
                  np.iinfo(np.int32).max], np.int32)
    hi, lo = (a.reshape(-1) for a in np.meshgrid(w, w, indexing="ij"))
    k = to_key(hi, lo)
    assert k.dtype == np.uint64
    pair = list(zip(hi.tolist(), lo.tolist()))
    for x in range(k.size):
        for y in range(k.size):
            assert (k[x] < k[y]) == (pair[x] < pair[y])
            assert (k[x] == k[y]) == (pair[x] == pair[y])
    order = np.argsort(k, kind="stable")
    assert np.array_equal(order, np.lexsort((lo, hi)))
    assert np.array_equal(np.stack(_from_key(k)), np.stack([hi, lo]))


def _runs(L, seed, spread):
    """Two sorted runs of L keys: many duplicates, distinct keys, a
    entirely below b, a entirely above b, or one key throughout."""
    rng = np.random.default_rng(seed)
    if spread == "equal":
        return np.full(L, 7, np.uint64), np.full(L, 7, np.uint64)
    top = {"duplicates": L // 4 + 2, "distinct": 1 << 62}.get(spread, 1000)
    a = np.sort(rng.integers(0, top, L).astype(np.uint64))
    b = np.sort(rng.integers(0, top, L).astype(np.uint64))
    if spread == "a_below":
        b += np.uint64(1000)
    elif spread == "a_above":
        a += np.uint64(1000)
    return a, b


@pytest.mark.parametrize("spread", ["duplicates", "distinct", "a_below",
                                    "a_above", "equal"])
@pytest.mark.parametrize("L,seed", [(16, 0), (100, 1), (4096, 2), (1, 3),
                                    (33, 4)])
def test_corank_warp_is_the_merge_path_split(L, seed, spread):
    rng = np.random.default_rng(seed)
    a, b = _runs(L, seed, spread)
    for d in sorted({0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L,
                     *rng.integers(0, 2 * L + 1, 40).tolist()}):
        i = _corank_warp(a, b, L, d)
        j = d - i
        assert 0 <= i <= L and 0 <= j <= L
        assert i == 0 or j == L or a[i - 1] <= b[j]       # a first on ties
        assert j == 0 or i == L or b[j - 1] < a[i]


def test_launches_per_call():
    assert [launches_per_call(n) for n in (1, 2, SMEM_N, 2 * SMEM_N,
                                           131072)] == [1, 1, 1, 2, 6]
    assert launches_per_call(64, 16) == 3


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
