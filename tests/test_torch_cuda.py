"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the torch-op engines on the card against the same engines
on CPU tensors.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports nothing of JAX, so it runs on a card host that has no
JAX installed, without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from comdb2_tpu_torch.checker import analysis
from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import mxu as MXU
from comdb2_tpu_torch.checker import pair_sort as PSORT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models.memo import memo
from comdb2_tpu_torch.models.model import cas_register
from comdb2_tpu_torch.ops.packed import pack_history
from comdb2_tpu_torch.ops.synth import (concurrent_writes, mutate,
                                         register_history)
from comdb2_tpu_torch.ops.synth_columnar import wide_register_batch_packed
from comdb2_tpu_torch.utils import next_pow2

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (n_procs, max_pending, mutate): 2-word and 3-word tiers, valid,
# invalid and overflowing histories
CASES = [(5, None, False), (5, None, True), (10, 5, False),
         (10, 5, True), (10, 10, False), (6, 4, True)]


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda, case):
    n_procs, mp, mut = case
    rng = random.Random(600 + CASES.index(case))
    h = register_history(rng, n_procs=n_procs, n_events=2000, values=5,
                         p_info=0.0, max_pending=mp)
    if mut:
        h = mutate(rng, h, values=5)
    packed = pack_history(h)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    p = max(p, 1)
    spec = SK.spec_for(mm.n_states, mm.n_transitions, p, 8)
    seg = torch.from_numpy(SK.pack_segments(segs, spec)).to(cuda)
    ws = torch.from_numpy(SK.initial_frontier(spec)).to(cuda)
    stat = torch.from_numpy(SK._init_stat()).to(cuda)
    table = torch.from_numpy(SK.pack_table(mm.succ)).to(cuda)
    before = SK.LAUNCHES
    got = SK.seg_search(seg, 0, mm.n_transitions, ws, stat, table, spec)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == before + 1
    want = SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat,
                                   table, spec)
    assert SK.LAUNCHES == before + 1
    assert got[:2] == want[:2]
    if got[0] != SK.UNKNOWN:
        assert got[2] == want[2]
        assert SK.decode_frontier(spec, got[3], p) == \
            SK.decode_frontier(spec, want[3], p)


class _MRecorder(dict):
    """A ``work`` dict that also keeps each closure iteration's m."""

    def __init__(self):
        super().__init__()
        self.ms = []

    def __setitem__(self, key, value):
        if key == "keys":
            self.ms.append(value - self.get("keys", 0))
        super().__setitem__(key, value)


@pytest.mark.parametrize("P", [6, 10])
def test_kernel_large_closures_match_plain_version(cuda, P):
    """A 10-process history with up to 5 calls in flight, its slots
    padded to P (2-word keys at 6, 3-word at 10): closures of 512 keys,
    and at P=10 of 1024."""
    rng = random.Random(1010)
    h = register_history(rng, n_procs=10, n_events=1500, values=5,
                         p_info=0.0, max_pending=5)
    packed = pack_history(h)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    spec = SK.spec_for(mm.n_states, mm.n_transitions, max(p, P), 8)
    seg = torch.from_numpy(SK.pack_segments(segs, spec)).to(cuda)
    ws = torch.from_numpy(SK.initial_frontier(spec)).to(cuda)
    stat = torch.from_numpy(SK._init_stat()).to(cuda)
    table = torch.from_numpy(SK.pack_table(mm.succ)).to(cuda)
    got = SK.seg_search(seg, 0, mm.n_transitions, ws, stat, table, spec)
    torch.cuda.synchronize()
    rec = _MRecorder()
    want = SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat,
                                   table, spec, work=rec)
    sizes = {1 << (m - 1).bit_length() for m in rec.ms}
    assert 512 in sizes and (1024 in sizes) == (P == 10)
    assert got[:3] == want[:3] and want[0] == SK.VALID
    assert SK.decode_frontier(spec, got[3], spec.P) == \
        SK.decode_frontier(spec, want[3], spec.P)


@pytest.mark.parametrize("k,P", [(6, None), (7, None), (8, None), (8, 15)])
def test_kernel_rare_paths_match_plain_version(cuda, k, P):
    """``concurrent_writes(k)``: merges of 4 and 8 new keys per lane
    (k = 6, 7) and the union path in the CTA's locked buffer (k = 8; at
    P=15 with 3-word keys), up to the overflow, bit-equal frontier and
    all (``tests/test_torch_seg_warp.py`` replays which path each takes)."""
    packed = pack_history(concurrent_writes(k), completed=True)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    spec = SK.spec_for(mm.n_states, mm.n_transitions, max(p, P or 1), 8)
    seg = torch.from_numpy(SK.pack_segments(segs, spec)).to(cuda)
    ws = torch.from_numpy(SK.initial_frontier(spec)).to(cuda)
    stat = torch.from_numpy(SK._init_stat()).to(cuda)
    table = torch.from_numpy(SK.pack_table(mm.succ)).to(cuda)
    got = SK.seg_search(seg, 0, mm.n_transitions, ws, stat, table, spec)
    torch.cuda.synchronize()
    want = SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat,
                                   table, spec)
    assert got[:3] == want[:3]
    assert SK.decode_frontier(spec, got[3], spec.P) == \
        SK.decode_frontier(spec, want[3], spec.P)


@pytest.mark.parametrize("seed", range(3))
def test_analysis_on_the_card_matches_cpu(cuda, seed):
    rng = random.Random(40 + seed)
    h = register_history(rng, n_procs=5, n_events=3000, values=5,
                         p_info=0.0)
    if seed:
        h = mutate(rng, h, values=5)
    a = analysis(cas_register(), h, device="cuda")
    b = analysis(cas_register(), h, device="cpu")
    assert a.info["engine"] == "cuda-seg"
    assert (a.valid, a.op_index, a.final_count, a.configs,
            a.info.get("paths")) == \
        (b.valid, b.op_index, b.final_count, b.configs,
         b.info.get("paths"))


def test_chunked_boundary_on_the_card_matches_cpu(cuda):
    rng = random.Random(8)
    for _ in range(20):
        h = mutate(rng, register_history(rng, n_procs=5, n_events=3000,
                                         values=5, p_info=0.0), values=5)
        packed = pack_history(h)
        mm = memo(cas_register(), packed)
        segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
        kw = dict(n_states=mm.n_states, n_transitions=mm.n_transitions,
                  P=max(p, 1), return_boundary=True, chunk=64)
        got = SK.check_device_seg_kernel_chunked(mm.succ, segs,
                                                 device="cuda", **kw)
        want = SK.check_device_seg_kernel_chunked(mm.succ, segs,
                                                  device="cpu", **kw)
        if want[0] == SK.INVALID:
            break
    assert got[:3] == want[:3] and want[0] == SK.INVALID
    spec = SK.spec_for(mm.n_states, mm.n_transitions, max(p, 1), 8)
    assert got[3][1] == want[3][1]
    assert SK.decode_frontier(spec, got[3][0], p) == \
        SK.decode_frontier(spec, want[3][0], p)


def _mixed_batch(n_events=400):
    """5-process valid and mutated histories with two 8-process
    histories that overflow the kernel's 128 configs in the middle."""
    rng = random.Random(5)
    hs = []
    for i in range(8):
        h = register_history(rng, n_procs=5, n_events=n_events, values=5,
                             p_info=0.0)
        hs.append(mutate(rng, h, values=5) if i % 2 else h)
    for seed in (0, 2):
        hs.insert(4, register_history(random.Random(seed), n_procs=8,
                                      n_events=160, values=5, p_info=0.0,
                                      max_pending=8))
    return TB.pack_batch(hs, cas_register())


@pytest.mark.parametrize("groups", [1, 3])
def test_stream_kernel_matches_plain_version(cuda, groups):
    tb = _mixed_batch()
    streams, _ = TB._stream_segments(tb)
    sizes = dict(n_states=tb.memo.n_states,
                 n_transitions=tb.memo.n_transitions)
    spec = TB._slice_spec(streams, sizes)
    seg, plan, _ = SK.pack_groups(streams, spec, groups)
    seg = torch.from_numpy(seg)
    table = torch.from_numpy(SK.pack_table(tb.memo.succ))
    n_hist = max(len(g) for g in plan)
    work = torch.zeros(len(plan), dtype=torch.int64, device=cuda)
    before = SK.STREAM_LAUNCHES
    got = SK.seg_search_stream(seg.to(cuda), sizes["n_transitions"],
                               table.to(cuda), spec, n_hist, work=work)
    torch.cuda.synchronize()
    assert SK.STREAM_LAUNCHES == before + 1
    want = SK.seg_search_stream(seg, sizes["n_transitions"], table, spec,
                                n_hist)
    assert torch.equal(got.cpu(), want)
    for g in range(len(plan)):
        w: dict = {}
        SK.seg_search_reference(
            seg[g], 0, sizes["n_transitions"],
            torch.from_numpy(SK.initial_frontier(spec)),
            torch.from_numpy(SK._init_stat()), table, spec, work=w,
            results=torch.zeros((n_hist, 3), dtype=torch.int32))
        assert int(work[g]) == w.get("compares", 0)
    st = want[:, :, 0].flatten().tolist()
    assert LT.INVALID in st and LT.UNKNOWN in st


def test_stream_kernel_in_full_ctas_matches_plain_version(cuda,
                                                         monkeypatch):
    """Ten group streams packed 8 warps to a CTA (one full CTA and one
    of two warps), as a launch of more streams than SMs runs."""
    tb = _mixed_batch()
    streams, _ = TB._stream_segments(tb)
    sizes = dict(n_states=tb.memo.n_states,
                 n_transitions=tb.memo.n_transitions)
    spec = TB._slice_spec(streams, sizes)
    seg, plan, _ = SK.pack_groups(streams, spec, len(streams))
    seg = torch.from_numpy(seg)
    table = torch.from_numpy(SK.pack_table(tb.memo.succ))
    monkeypatch.setattr(SK, "launch_geometry", lambda n, sms: (
        -(-n // SK.WARPS_PER_CTA), SK.WARPS_PER_CTA))
    got = SK.seg_search_stream(seg.to(cuda), sizes["n_transitions"],
                               table.to(cuda), spec, 1)
    torch.cuda.synchronize()
    want = SK.seg_search_stream(seg, sizes["n_transitions"], table, spec, 1)
    assert seg.shape[0] == 10
    assert torch.equal(got.cpu(), want)


def test_stream_kernel_locked_union_in_a_full_cta(cuda, monkeypatch):
    """Eight group streams in one 8-warp CTA, each starting with two
    ``concurrent_writes(8)`` histories (at P = 8 their third closure
    iteration sorts 585 keys in the CTA's locked buffer, so all eight
    warps compete for it at once) and ending with a (c)-family history:
    results, work and need bit-equal to the plain version."""
    rng = random.Random(1010)
    cw = pack_history(concurrent_writes(8), completed=True)
    hs = [cw] * 16 + [register_history(rng, n_procs=10, n_events=300,
                                       values=5, p_info=0.0, max_pending=5)
                      for _ in range(8)]
    tb = TB.pack_batch(hs, cas_register())
    streams, _ = TB._stream_segments(tb)
    sizes = dict(n_states=tb.memo.n_states,
                 n_transitions=tb.memo.n_transitions)
    spec = TB._slice_spec(streams, sizes)
    monkeypatch.setattr(SK, "plan_groups", lambda sizes_, G: [
        [2 * g, 2 * g + 1, 16 + g] for g in range(G)])
    seg, _, _ = SK.pack_groups(streams, spec, 8)
    assert spec.P == 8
    seg = torch.from_numpy(seg)
    table = torch.from_numpy(SK.pack_table(tb.memo.succ))
    monkeypatch.setattr(SK, "launch_geometry", lambda n, sms: (
        -(-n // SK.WARPS_PER_CTA), SK.WARPS_PER_CTA))
    work = torch.zeros(8, dtype=torch.int64, device=cuda)
    need = torch.zeros_like(work)
    got = SK.seg_search_stream(seg.to(cuda), sizes["n_transitions"],
                               table.to(cuda), spec, 3, work=work,
                               need=need)
    torch.cuda.synchronize()
    want = torch.zeros((8, 3, 3), dtype=torch.int32)
    for g in range(8):
        rec = _MRecorder()
        SK.seg_search_reference(
            seg[g], 0, sizes["n_transitions"],
            torch.from_numpy(SK.initial_frontier(spec)),
            torch.from_numpy(SK._init_stat()), table, spec, work=rec,
            results=want[g])
        assert 585 in rec.ms
        assert int(work[g]) == rec["compares"]
        assert int(need[g]) == SK.needed_compares(rec.ms, spec.P)
    assert torch.equal(got.cpu(), want)
    assert want[:, :2, 0].eq(LT.UNKNOWN).all()


def _sort_rows(B, N, rows="random"):
    g = torch.Generator().manual_seed(B * N)
    hi = torch.randint(-8, 8, (B, N), generator=g, dtype=torch.int32)
    lo = torch.randint(-2**31, 2**31 - 1, (B, N), generator=g,
                       dtype=torch.int32)
    hi[:, :N // 4] = 1 << 30                  # block sentinels
    lo[:, :N // 4] = 5
    if rows == "equal":
        hi.fill_(-3)
        lo.fill_(-2**31)
    elif rows == "reversed":
        hi, lo = (t.flip(1).contiguous()
                  for t in PSORT.pair_sort_reference(hi, lo))
    elif rows == "corners":
        w = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2,
                          2**31 - 1], dtype=torch.int32)
        hi = w[torch.randint(0, 7, (B, N), generator=g)]
        lo = w[torch.randint(0, 7, (B, N), generator=g)]
    return hi, lo


T = PSORT.SMEM_N


@pytest.mark.parametrize("B,N,rows", [
    (64, 2048, "random"), (3, 8192, "random"), (2, 65536, "random"),
    (4, 131072, "random"), (5, 2, "random"), (8, 131072, "random"),
    (1, T, "random"), (1, 2 * T, "random"), (256, 4096, "random"),
    (8, 131072, "equal"), (3, 2 * T, "equal"), (8, 131072, "reversed"),
    (5, T, "reversed"), (7, 64, "corners"), (2, 4 * T, "corners"),
    (3, 1, "random")])
def test_pair_sort_kernel_matches_plain_version(cuda, B, N, rows):
    hi, lo = _sort_rows(B, N, rows)
    before = PSORT.LAUNCHES
    got = PSORT.pair_sort(hi.to(cuda), lo.to(cuda))
    torch.cuda.synchronize()
    assert PSORT.LAUNCHES == before + 1
    want = PSORT.pair_sort_reference(hi, lo)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_pair_sort_on_a_side_stream_and_unaligned_inputs(cuda):
    hi, lo = _sort_rows(8, 131072)
    want = PSORT.pair_sort_reference(hi, lo)
    side = torch.cuda.Stream()
    # rows one element into their storage: not 16-byte aligned
    hi_u = torch.cat([hi.new_zeros(1), hi.reshape(-1)]).to(cuda)[1:]
    lo_u = torch.cat([lo.new_zeros(1), lo.reshape(-1)]).to(cuda)[1:]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = PSORT.pair_sort(hi_u.view(8, 131072), lo_u.view(8, 131072))
        again = PSORT.pair_sort(got[1][:2].contiguous(),
                                got[0][:2].contiguous())
    side.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    want2 = PSORT.pair_sort_reference(want[1][:2].contiguous(),
                                      want[0][:2].contiguous())
    assert torch.equal(again[0].cpu(), want2[0])
    assert torch.equal(again[1].cpu(), want2[1])


def test_pair_sort_library_shape_and_phases(cuda):
    from comdb2_tpu_torch.kernels import build

    lib = build.load("pair_sort")
    assert lib.pair_sort_tile() == PSORT.SMEM_N
    attrs = PSORT.kernel_attrs(lib)
    for name in ("block", "merge"):
        assert 0 < attrs[name]["registers"] <= 255
        assert attrs[name]["local_bytes"] == 0        # no spills
    hi, lo = _sort_rows(8, 131072)
    ms = PSORT.phase_ms(hi.to(cuda), lo.to(cuda), reps=2)
    assert len(ms) == 6 and all(m > 0 for m in ms)


def test_check_batch_on_the_card_matches_cpu(cuda):
    tb = _mixed_batch()
    before = PSORT.LAUNCHES
    info: dict = {}
    got = TB.check_batch(tb, F=1024, device="cuda", info=info)
    assert info["engine"] == "stream"
    assert info["escalated"]["engine"] == "keys"
    assert PSORT.LAUNCHES > before
    want = TB.check_batch(tb, F=1024, device="cpu")
    for a, b in zip(got, want):
        assert a.tolist() == b.tolist()


def _j_batch(n_lanes, n_events, n_overflow):
    """Request (j) of ``chip_smoke.py`` at a small size: eight-process
    lanes over 8 values (about 77 transitions at 2000 events), the
    first ``n_overflow`` with 8 calls in flight, the rest with 4."""
    hs = [register_history(random.Random(900 + i), n_procs=8,
                           n_events=n_events, values=8, p_info=0.0,
                           max_pending=8 if i < n_overflow else 4)
          for i in range(n_lanes)]
    return hs, TB.pack_batch(hs, cas_register())


def test_vmap_escalation_on_the_card_matches_cpu(cuda):
    """(j), small: the stream kernel, then its overflowed lanes through
    the vmap engine at F; the card's verdicts equal the CPU tensors'."""
    hs, tb = _j_batch(16, 600, 2)
    m = tb.memo
    if TB.pick_engine(2, m.n_states, m.n_transitions, 8) != "vmap":
        pytest.skip(f"table {m.n_states}x{m.n_transitions} fits keys")
    info: dict = {}
    got = TB.check_batch(tb, F=2048, device="cuda", info=info)
    assert info["engine"] == "stream"
    assert info["escalated"]["engine"] == "vmap"
    want = TB.check_batch(tb, F=2048, device="cpu")
    for a, b in zip(got[:2], want[:2]):
        assert a.tolist() == b.tolist()
    valid = want[0] == LT.VALID
    assert got[2][valid].tolist() == want[2][valid].tolist()
    for i, h in enumerate(hs):
        r = analysis(cas_register(), h, device="cuda")
        st = {True: LT.VALID, False: LT.INVALID}.get(r.valid, LT.UNKNOWN)
        if st != LT.UNKNOWN:
            assert int(got[0][i]) == st, i


@pytest.mark.parametrize("engine", ["flat", "vmap"])
def test_flat_and_vmap_on_the_card_match_keys(cuda, engine):
    """(j2), small: the mixed batch through flat and vmap on the card
    equals the keys engine in status and fail index, and in n_final on
    VALID lanes."""
    tb = _mixed_batch()
    want = TB.check_batch(tb, F=1024, engine="keys", device="cuda")
    info: dict = {}
    got = TB.check_batch(tb, F=1024, engine=engine, device="cuda",
                         info=info)
    assert info["engine"] == engine
    for a, b in zip(got[:2], want[:2]):
        assert a.tolist() == b.tolist()
    valid = want[0] == LT.VALID
    assert got[2][valid].tolist() == want[2][valid].tolist()


def test_no_nvcc_and_no_library_raise_on_the_card(cuda, monkeypatch,
                                                   tmp_path):
    """A card whose host cannot build the kernels (no ``nvcc``, nothing
    built): ``analysis`` and ``check_batch`` on the card raise the
    build's error; nothing falls back to another engine."""
    from comdb2_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIBS", {})
    h = register_history(random.Random(1), n_procs=5, n_events=400,
                         values=5, p_info=0.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        analysis(cas_register(), h, device="cuda", backend="device")
    tb = TB.pack_batch([h, h], cas_register())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TB.check_batch(tb, F=256, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TB.check_batch(tb, F=256, engine="keys", device="cuda")


def test_seg2_and_keys_on_the_card_match_cpu(cuda):
    h = register_history(random.Random(0), n_procs=8, n_events=400,
                         values=5, p_info=0.0, max_pending=8)
    packed = pack_history(h)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    P = max(p + (p & 1), 2)
    kw = dict(F=1024, Fs=32, P=P, n_states=mm.n_states,
              n_transitions=mm.n_transitions)
    args = (mm.succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    assert LT.check_device_seg2(*args, device="cuda", **kw) == \
        LT.check_device_seg2(*args, device="cpu", **kw)


def test_mxu_on_the_card_matches_cpu(cuda):
    p = wide_register_batch_packed(47, 1, n_waves=2, n_chain=7, n_free=9,
                                   values=16)[0]
    mm = memo(cas_register(), p)
    segs, pe = LT.remap_slots(LT.make_segments(p, s_pad=64, k_pad=4))
    succ = LT.pad_succ(mm.succ, next_pow2(mm.n_states),
                       next_pow2(mm.n_transitions))
    args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    kw = dict(F=1024, P=pe, n_states=mm.n_states,
              n_transitions=mm.n_transitions)
    assert MXU.check_device_mxu(*args, device="cuda", **kw) == \
        MXU.check_device_mxu(*args, device="cpu", **kw)


# --- the checker layer: closure, check_txn, workload families -----------------

def _closure_planes(seed, n):
    """(4, n, n) planes: acyclic local ww / wr / rw chains, a dense
    realtime plane, and on odd seeds an rw back edge (a G2 cycle)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    up = np.triu(np.ones((n, n), bool), 1)
    band = up & ~np.triu(np.ones((n, n), bool), 7)
    adj = np.zeros((4, n, n), bool)
    for p in range(3):
        adj[p] = band & (rng.random((n, n)) < 0.35)
    adj[3] = up & (rng.random((n, n)) < 0.5)
    if seed % 2:
        adj[2, n - 1, 0] = True
    return adj


@pytest.mark.parametrize("realtime", [False, True])
def test_closure_on_the_card_matches_the_host_scc(cuda, realtime):
    import numpy as np

    from comdb2_tpu_torch.txn import closure_torch as TCL
    from comdb2_tpu_torch.txn.scc import cyclic_layers_host

    n = 512
    for seed in (0, 1):
        adj = _closure_planes(seed, n)
        before = TCL.DISPATCHES
        got = TCL.cyclic_layers_device(adj, realtime=realtime, device=cuda)
        assert TCL.DISPATCHES == before + 1
        assert np.array_equal(got, cyclic_layers_host(adj, realtime))
    adjs = np.stack([_closure_planes(s, n) for s in range(4)])
    got = TCL.closure_diag_batch(adjs, device=cuda)
    for b in range(4):
        assert np.array_equal(got[b], cyclic_layers_host(adjs[b], True))
    assert got[1, 2].any() and not got[0].any()


@pytest.mark.parametrize("family,violation", [
    ("bank", None), ("bank", "total"), ("bank", "snapshot"),
    ("sets", None), ("sets", "lost"), ("sets", "phantom"),
    ("dirty", None), ("dirty", "dirty"), ("dirty", "malformed")])
def test_wl_families_on_the_card_agree_with_the_host_oracle(cuda, family,
                                                             violation):
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.checker.wl import batch as WB

    if family == "bank":
        hs, model = W.bank_batch(21, 40, n_transfers=100, n_reads=70,
                                 violation=violation)
    else:
        gen = W.sets_batch if family == "sets" else W.dirty_batch
        hs, model = gen(21, 40, violation=violation), None
    before = WB.DISPATCHES
    got = W.check_wl_batch(hs, family, model, device=cuda)
    assert WB.DISPATCHES == before + 1
    assert got == W.check_wl_batch(hs, family, model, device="cpu")
    host = WB._host_fallback(hs, family, model)
    assert all(WB.agrees_with_oracle(family, d, o, h)
               for d, o, h in zip(got, host, hs))


def test_check_txn_on_the_card_on_the_g2_fixture(cuda):
    import os

    from comdb2_tpu_torch.ops.history import parse_history
    from comdb2_tpu_torch.txn import check_txn
    from comdb2_tpu_torch.txn import closure_torch as TCL

    path = os.path.join(os.path.dirname(__file__), "fixtures", "txn",
                        "g2_item.edn")
    with open(path) as fh:
        h = parse_history(fh.read())
    before = TCL.DISPATCHES
    got = check_txn(h, backend="device")
    assert TCL.DISPATCHES == before + 1
    assert got == check_txn(h, backend="host")
    assert got["valid?"] is False
    assert got["counterexample"]["class"] == "G2-item"


# --- streaming sessions ----------------------------------------------------------

def _stream_feed(session, h, step):
    outs = [session.append(h[i:i + step]) for i in range(0, len(h), step)]
    return outs, session.finalize_input()


def test_stream_kernel_rung_on_the_card_matches_cpu(cuda):
    """A kernel-rung session on the card (``seg_search.cu`` in carry
    mode, one launch per delta) and its twin on CPU tensors (the plain
    version) agree after every append, frontier words and stat bits
    included."""
    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.stream import engine as TE

    h = mutate(random.Random(8), register_history(
        random.Random(8), n_procs=5, n_events=600, values=5,
        p_info=0.0), values=5)
    card = StreamSession(engine="kernel")
    host = StreamSession(engine="kernel", device="cpu")
    before = SK.LAUNCHES
    for i in range(0, len(h), 40):
        d0 = TE.DISPATCHES
        oc, oh = card.append(h[i:i + 40]), host.append(h[i:i + 40])
        assert oc == oh
        if card.valid is True and card.replays == 0:
            assert TE.DISPATCHES - d0 <= 2          # one per session
            assert torch.equal(card._eng.ws.cpu(), host._eng.ws)
            assert torch.equal(card._eng.stat.cpu(), host._eng.stat)
    assert card.finalize_input() == host.finalize_input()
    assert SK.LAUNCHES > before
    assert card._eng.ws.is_cuda


def test_stream_fused_beat_on_the_card_matches_solo(cuda):
    """One fused kernel-rung beat of 5 sessions on the card (5 launches,
    one readback) leaves each carry bit-equal to the same session run
    solo on the card."""
    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.stream import engine as TE

    hs = [register_history(random.Random(900 + i), n_procs=5,
                           n_events=400, values=5, p_info=0.0)
          for i in range(5)]
    fused = [StreamSession(engine="kernel") for _ in hs]
    solo = [StreamSession(engine="kernel") for _ in hs]
    for s, t, h in zip(fused, solo, hs):
        s.append(h[:200])
        t.append(h[:200])
    coll = TE.MegaBatch()
    fins = [s.append_stage(h[200:], collector=coll)
            for s, h in zip(fused, hs)]
    coll.flush()
    outs = [f() for f in fins]
    for t, h, o in zip(solo, hs, outs):
        assert t.append(h[200:]) == o
    for s, t in zip(fused, solo):
        assert torch.equal(s._eng.ws, t._eng.ws)
        assert torch.equal(s._eng.stat, t._eng.stat)
