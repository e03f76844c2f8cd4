"""The segment-search kernel's in-warp schedule, replayed in numpy.

``kernels/seg_search.cu`` runs one segment stream per warp. A closure
iteration over the sorted frontier ``fr[0, n)``:

- gathers the new candidates: each lane expands 4 candidates at a time,
  finds each in the frontier with a fixed-step binary search, and one
  ``__ballot_sync`` + ``__popc`` per candidate packs the new ones into the
  warp's buffer;
- sorts them in registers when there are at most 256, ``R`` keys per
  lane in blocked order (key ``i`` in lane ``i // R``, slot ``i % R``):
  compare-exchanges within a lane for partner distance < R, through
  ``__shfl_xor_sync`` for distance >= R; duplicates against the
  predecessor (in the lane, or ``__shfl_up_sync`` from the lane before);
  positions from one ballot per slot;
- merges them: every key lands at its index plus its rank in the other
  list, and the first 128 of the union are kept;
- or, past 256 new candidates, sorts the whole union over a shared-memory
  buffer, lane ``l`` taking pairs ``l, l + 32, ...`` of each stage, then
  deduplicates ``M / 32`` consecutive keys per lane with a prefix sum.

The CUDA code cannot run here, so these tests replay each step lane by
lane as the kernel performs it and hold the result to ``sort`` +
``unique``; the card tests (``test_torch_cuda.py``) hold the kernel itself
to its plain version. The warp-stream planner's geometry is tested too.
"""

import random

import numpy as np
import pytest

from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models.memo import memo
from comdb2_tpu_torch.models.model import cas_register
from comdb2_tpu_torch.ops.packed import pack_history
from comdb2_tpu_torch.ops.synth import concurrent_writes

WARP = 32
F_CAP = 128
SENT_HI = SK.SENT_HI
REG_KEYS = 256            # seg_search.cu: the most keys sorted in registers


def sort_variant(count):
    """How the kernel sorts ``count`` keys (seg_search.cu's thresholds):
    ``(R, M)`` with ``M = next_pow2(count)``, ``R`` keys per lane in
    registers when ``M <= REG_KEYS``; else ``R = 0``, shared memory, ``M``
    at least 512. A closure iteration sorts its new candidates so when
    they are at most REG_KEYS, and all its keys otherwise."""
    M = 1 << max(count - 1, 0).bit_length()
    if M <= REG_KEYS:
        return max(M // WARP, 1), M
    return 0, max(M, 2 * REG_KEYS)


def _less(a, b):
    """key_less: signed words compared from the top word down (a, b are
    (..., W) int64 arrays of int32 values)."""
    lt = a[..., 0] < b[..., 0]
    for w in range(1, a.shape[-1]):
        lt = (a[..., w] < b[..., w]) | ((a[..., w] == b[..., w]) & lt)
    return lt


def _sentinel(W):
    s = np.zeros(W, np.int64)
    s[-1] = SENT_HI
    return s


def _keys(m, W, seed, pool=None):
    """m keys with duplicates, negative words and sentinels among them."""
    rng = np.random.default_rng(seed)
    if pool is None:
        pool = rng.integers(-2**31, 2**31, (max(m // 3, 1), W))
        pool[:, -1] = rng.integers(-50, 50, pool.shape[0])   # top word
    keys = pool[rng.integers(0, pool.shape[0], m)]
    keys[rng.random(m) < 0.1] = _sentinel(W)
    return keys


def _want(keys):
    """sort + unique of the valid keys, top word most significant."""
    valid = keys[keys[:, -1] < SENT_HI]
    if not valid.shape[0]:
        return valid
    return np.unique(valid[:, ::-1], axis=0)[:, ::-1]


def _positions(keep):
    """warp_positions: keep (32, R) in blocked order -> output positions
    from per-slot ballots and popcounts, and the warp's total."""
    R = keep.shape[1]
    ballots = [sum(int(keep[l, r]) << l for l in range(WARP))
               for r in range(R)]
    pos = np.zeros((WARP, R), np.int64)
    for lane in range(WARP):
        lt = (1 << lane) - 1
        p = sum(bin(b & lt).count("1") for b in ballots)
        for r in range(R):
            pos[lane, r] = p
            p += int(keep[lane, r])
    return pos, sum(bin(b).count("1") for b in ballots)


def _sort_registers(keys, R, logm):
    """warp_sort: ``keys`` (m, W) are the first m of 32 R blocked
    elements, the rest sentinels; the stages of the first 2^logm."""
    m, W = keys.shape
    k = np.tile(_sentinel(W), (WARP * R, 1))
    k[:m] = keys
    k = k.reshape(WARP, R, W)
    idx = np.arange(WARP)[:, None] * R + np.arange(R)[None, :]
    for a in range(1, logm + 1):
        for bb in range(a - 1, -1, -1):
            j = 1 << bb
            if j >= R:                           # __shfl_xor_sync
                o = k[np.arange(WARP) ^ (j // R)]
                keep_min = ((idx & j) == 0) == (((idx >> a) & 1) == 0)
                take = np.where(keep_min, _less(o, k), _less(k, o))
                k = np.where(take[..., None], o, k)
            else:                                # within the lane
                for r in range(R):
                    if r & j:
                        continue
                    r2 = r | j
                    asc = ((idx[:, r] >> a) & 1) == 0
                    swap = _less(k[:, r2], k[:, r]) == asc
                    lo, hi = k[:, r].copy(), k[:, r2].copy()
                    k[:, r] = np.where(swap[:, None], hi, lo)
                    k[:, r2] = np.where(swap[:, None], lo, hi)
    return k


def _dedup(k):
    """Predecessor dedup (``__shfl_up_sync(.., 1)`` of the last slot for
    slot 0) and ballot positions: (keep, pos, total)."""
    R = k.shape[1]
    prev = k[np.maximum(np.arange(WARP) - 1, 0), R - 1]
    valid = k[..., -1] < SENT_HI
    keep = np.zeros((WARP, R), bool)
    keep[:, 0] = valid[:, 0] & ((np.arange(WARP) == 0)
                                | (k[:, 0] != prev).any(-1))
    for r in range(1, R):
        keep[:, r] = valid[:, r] & (k[:, r] != k[:, r - 1]).any(-1)
    pos, total = _positions(keep)
    return keep, pos, total


def _logm(count, R):
    """The stages merge_new runs: those of next_pow2(count) for R = 1,
    all 5 + lg R otherwise."""
    return max(count - 1, 1).bit_length() if R == 1 else 4 + R.bit_length()


def replay_registers(keys, R):
    """Sort and deduplicate ``keys`` in registers; returns the kept keys
    in order and their count."""
    k = _sort_registers(keys, R, _logm(keys.shape[0], R))
    keep, pos, total = _dedup(k)
    out = np.zeros((total, keys.shape[1]), np.int64)
    for lane in range(WARP):
        for r in range(R):
            if keep[lane, r]:
                out[pos[lane, r]] = k[lane, r]
    return out, total


def lower_bound(buf, length, key):
    """The kernel's fixed-step binary search: keys of buf[0, length)
    below ``key``."""
    pos = 0
    step = 1 << (length.bit_length() - 1) if length > 0 else 0
    while step > 0:
        cand = pos + step
        m = buf[min(cand, length) - 1]
        if cand <= length and bool(_less(m, key)):
            pos = cand
        step >>= 1
    return pos


def replay_merge(fr, cands):
    """One closure iteration's gather and merge: ``fr`` (n, W) sorted
    unique, ``cands`` (c, W) the expansion candidates. Returns (the first
    128 keys of the union, the union's size, the new-candidate count);
    the first two are None when the kernel takes the union path."""
    n, W = fr.shape
    total = n + cands.shape[0]
    wbuf, count = [], 0
    for e0 in range(n, total, 4 * WARP):
        for u in range(4):
            nw = []
            for lane in range(WARP):
                e = e0 + u * WARP + lane
                k = cands[e - n] if e < total else _sentinel(W)
                pos = lower_bound(fr, n, k)
                found = pos < n and (fr[min(pos, n - 1)] == k).all()
                nw.append(bool(k[-1] < SENT_HI) and not found)
                if nw[-1]:
                    wbuf.append(k)               # ballot order = lane order
            count += sum(nw)
    if count == 0:
        return fr[:F_CAP], n, 0
    R, _ = sort_variant(count)
    if R == 0:
        return None, None, count
    new, uniq = replay_registers(np.array(wbuf), R)
    out = np.zeros((n + uniq, W), np.int64)
    for t in range(uniq):
        out[t + lower_bound(fr, n, new[t])] = new[t]
    for i in range(n):
        out[i + lower_bound(new, uniq, fr[i])] = fr[i]
    return out[:F_CAP], n + uniq, count


def replay_shared(keys, M):
    """The union path: the bitonic network over M keys in shared memory,
    lane ``l`` taking pairs l, l + 32, ... of each stage; then each lane
    deduplicates its M / 32 consecutive keys and a prefix sum places
    them."""
    m, W = keys.shape
    buf = np.tile(_sentinel(W), (M, 1))
    buf[:m] = keys
    kk = 2
    while kk <= M:
        j = kk >> 1
        while j > 0:
            for lane in range(WARP):
                for p in range(lane, M >> 1, WARP):
                    i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
                    l_ = i + j
                    if bool(_less(buf[l_], buf[i])) == ((i & kk) == 0):
                        buf[[i, l_]] = buf[[l_, i]]
            j >>= 1
        kk <<= 1
    per = M // WARP
    keep = [buf[i, -1] < SENT_HI and (i == 0 or (buf[i] != buf[i - 1]).any())
            for i in range(M)]
    cnt = [sum(keep[lane * per:(lane + 1) * per]) for lane in range(WARP)]
    incl = np.cumsum(cnt)                     # the __shfl_up_sync scan
    fr = np.zeros((F_CAP, W), np.int64)
    for lane in range(WARP):
        pos = incl[lane] - cnt[lane]
        for i in range(lane * per, (lane + 1) * per):
            if keep[i]:
                if pos < F_CAP:
                    fr[pos] = buf[i]
                pos += 1
    total = int(incl[-1])
    return fr[:min(total, F_CAP)], total


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("m", [2, 3, 7, 16, 31, 32, 33, 50, 64, 65, 100,
                               128, 129, 200, 255, 256])
def test_register_network_equals_sort_unique(W, m):
    keys = _keys(m, W, seed=1000 * W + m)
    R, M = sort_variant(m)
    assert R * WARP == max(M, WARP)
    out, total = replay_registers(keys, R)
    want = _want(keys)
    assert total == want.shape[0]
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("n,c", [(1, 6), (9, 72), (20, 120), (65, 200),
                                 (100, 30), (128, 0), (127, 255),
                                 (40, 400)])
def test_gather_and_merge_equal_sort_unique_of_the_union(W, n, c):
    """A sorted frontier of n keys and c candidates drawn partly from it:
    the first 128 of the merged union, its size, and the count of new
    candidates that picks the variant."""
    rng = np.random.default_rng(100 * W + n + c)
    pool = rng.integers(-2**31, 2**31, (n + c, W))
    pool[:, -1] = rng.integers(-50, 50, pool.shape[0])
    fr = _want(pool[:n])
    draw = np.concatenate([fr, pool[n:]]) if fr.shape[0] else pool[n:]
    cands = _keys(c, W, seed=7 * c + W, pool=draw) if c else \
        np.zeros((0, W), np.int64)
    out, size, count = replay_merge(fr, cands)
    union = _want(np.concatenate([fr, cands]))
    new = [k for k in cands if k[-1] < SENT_HI
           and not (fr == k).all(-1).any()]
    assert count == len(new)
    if count > REG_KEYS:
        assert out is None                   # the union path's business
        return
    assert size == union.shape[0]
    np.testing.assert_array_equal(out, union[:F_CAP])


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("m", [257, 300, 512, 513, 896])
def test_shared_memory_network_equals_sort_unique(W, m):
    keys = _keys(m, W, seed=7000 * W + m)
    R, M = sort_variant(m)
    assert R == 0 and M == max(1 << (m - 1).bit_length(), 2 * REG_KEYS)
    fr, total = replay_shared(keys, M)
    want = _want(keys)
    assert total == want.shape[0]
    np.testing.assert_array_equal(fr, want[:F_CAP])


@pytest.mark.parametrize("m,variant", [
    (1, (1, 1)), (2, (1, 2)), (32, (1, 32)), (33, (2, 64)), (64, (2, 64)),
    (65, (4, 128)), (129, (8, 256)), (256, (8, 256)), (257, (0, 512)),
    (512, (0, 512)), (513, (0, 1024)), (1920, (0, 2048))])
def test_sort_variant_thresholds(m, variant):
    assert sort_variant(m) == variant


def _new_counts(k, P=None):
    """The new-candidate count of each closure iteration of the first
    segment of ``concurrent_writes(k)``, replayed on the kernel's key
    layout (the plain version's expansion)."""
    packed = pack_history(concurrent_writes(k), completed=True)
    mm = memo(cas_register(), packed)
    segs, pe = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    spec = SK.spec_for(mm.n_states, mm.n_transitions, max(pe, P or 1), 8)
    table = SK.pack_table(mm.succ)
    W, stride = spec.n_words, mm.n_transitions
    root = np.array(SK.initial_frontier(spec)[:, 0], np.int64)
    fr = root[None]
    for p, tr in zip(segs.inv_proc[0], segs.inv_tr[0]):
        if p >= 0:
            w, sh = spec.slot_pos[p]
            fr[:, w] += (tr + 1) << sh
    counts = []
    sw, ssh = spec.state_pos
    for _ in range(int(segs.depth[0])):
        cands = []
        for key in fr:
            s = (key[sw] >> ssh) & ((1 << spec.state_bits) - 1)
            for q, (w, sh) in enumerate(spec.slot_pos):
                tq = (key[w] >> sh) & ((1 << spec.slot_bits) - 1)
                idx = s * stride + tq - 2
                if tq >= 2 and idx < table.size and table[idx] >= 0:
                    c = key.copy()
                    c[w] -= tq << sh
                    c[sw] += (int(table[idx]) - s) << ssh
                    cands.append(c)
        counts.append(sum(not (fr == c).all(-1).any() for c in cands))
        fr = _want(np.concatenate([fr, np.array(cands).reshape(-1, W)]))
        if counts[-1] == 0 or fr.shape[0] > F_CAP:
            break
    return spec, counts


@pytest.mark.parametrize("k,P,want", [
    (6, None, {1, 4, 8}), (7, None, {1, 2, 8}), (8, None, {1, 2, 0}),
    (8, 15, {1, 2, 0})])
def test_concurrent_writes_reach_every_kernel_path(k, P, want):
    """The histories the card tests and ``chip_smoke.py`` use to drive
    the rare paths: R = 4 and 8 merges, and the union path (more than
    256 new candidates) with 2- and 3-word keys."""
    spec, counts = _new_counts(k, P)
    assert {sort_variant(c)[0] for c in counts if c} == want
    assert spec.n_words == (3 if P == 15 else 1 if k == 6 else 2)


@pytest.mark.parametrize("sizes,G", [
    ([100, 5, 90, 7, 50, 50, 3, 1], 3),
    ([1470] * 4096, 3168),
    ([1470 + (b * 37) % 200 for b in range(4096)], 4224),
    ([1, 2, 3], 10),
    ([388] * 48 + [40] * 8, 56 * 24),
    (list(range(1, 300)), 7)])
def test_planner_covers_every_history_once_balanced(sizes, G):
    plan = SK.plan_groups(sizes, G)
    assert sorted(b for g in plan for b in g) == list(range(len(sizes)))
    assert len(plan) == min(G, len(sizes))
    assert all(g == sorted(g) for g in plan)
    loads = [sum(sizes[b] + 1 for b in g) for g in plan]
    # longest-first onto the lightest stream: no stream is more than one
    # history heavier than the lightest
    assert max(loads) - min(loads) <= max(sizes) + 1


@pytest.mark.parametrize("n_streams,sms,want", [
    (1, 132, (1, 1)), (56, 132, (56, 1)), (132, 132, (132, 1)),
    (133, 132, (67, 2)), (792, 132, (132, 6)), (3168, 132, (396, 8)),
    (4224, 132, (528, 8)), (5000, 132, (625, 8)), (10, 1, (2, 8))])
def test_launch_geometry(n_streams, sms, want):
    ctas, warps = SK.launch_geometry(n_streams, sms)
    assert (ctas, warps) == want
    assert 1 <= warps <= SK.WARPS_PER_CTA
    assert ctas * warps >= n_streams > (ctas - 1) * warps
    if n_streams <= sms:
        assert warps == 1        # a small launch spreads one warp per SM


def test_plan_streams_from_a_seeded_batch():
    """Histories of seeded segment counts over the (g) geometry: every
    stream at most one history longer than the lightest."""
    rng = random.Random(11)
    sizes = [rng.randint(1300, 1600) for _ in range(4096)]
    plan = SK.plan_groups(sizes, 3168)
    assert max(len(g) for g in plan) == 2 and min(len(g) for g in plan) == 1
    assert sum(len(g) for g in plan) == 4096


@pytest.mark.parametrize("ms,P,want", [
    ([], 6, 0),
    ([2], 1, 1),
    # concurrent_writes(8)'s first segment at P = 8: n = 1, 9, 65; the
    # lookups, then 8 and 56 new keys sorted
    ([9, 81, 585], 8, 1 * 8 * 1 + 9 * 8 * 4 + 65 * 8 * 7 + 8 * 3 + 56 * 6),
    # n = 2, 1, 1, 3: only a rise counts new keys
    ([14, 7, 7, 21], 6, 24 + 6 + 6 + 36 + 2 * 1)])
def test_needed_compares(ms, P, want):
    assert SK.needed_compares(ms, P) == want


@pytest.mark.parametrize("k", [6, 7, 8])
def test_needed_compares_fall_below_the_plain_count(k):
    """The bound's count on the plain version's own iterations: at most
    the parity count ``compares`` (which sorts every key anew)."""
    import torch

    class Rec(dict):
        def __init__(self):
            super().__init__()
            self.ms = []

        def __setitem__(self, key, value):
            if key == "keys":
                self.ms.append(value - self.get("keys", 0))
            super().__setitem__(key, value)

    packed = pack_history(concurrent_writes(k), completed=True)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    spec = SK.spec_for(mm.n_states, mm.n_transitions, p, 8)
    rec = Rec()
    SK.seg_search_reference(
        torch.from_numpy(SK.pack_segments(segs, spec)), 0, mm.n_transitions,
        torch.from_numpy(SK.initial_frontier(spec)),
        torch.from_numpy(SK._init_stat()),
        torch.from_numpy(SK.pack_table(mm.succ)), spec, work=rec)
    need = SK.needed_compares(rec.ms, spec.P)
    assert rec.ms and 0 < need < rec["compares"]
