"""The port's batch path (``checker/batch.py``, the stream host half of
``checker/seg_kernel.py``) against the JAX package.

- Host arrays byte-equal: ``pack_batch``, ``segment_batch``,
  ``remap_slots_batch``, ``pack_stream`` rows and starts,
  ``plan_stream_slices`` / ``merge_stream_slice``, the escalation
  helpers.
- ``check_batch`` verdicts on a mixed batch — valid, INVALID,
  overflowing the kernel's 128 configs (checked at a larger F) and a
  malformed double-pending lane that must come back unknown: the keys
  engine bit-equal to the JAX keys engine in ``(status, fail_at,
  n_final)``; the stream engine (the default) equal in ``(status,
  fail_at)`` and in ``n_final`` wherever the history is not INVALID
  (on INVALID the kernel zeroes its count, the key engines keep the
  pre-death one — the JAX package's cross-engine contract).
- The stream kernel's plain version with several histories per group
  stream: an INVALID and an overflowing history in the middle do not
  stop the ones after them; every history's ``(status, fail, n)``
  equals its own single-history kernel run.
"""

import random

import numpy as np
import pytest
import torch

import comdb2_tpu.checker.batch as JB
from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu_torch.checker import EngineNotPorted
from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops.packed import pack_history as torch_pack


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch ops here are tiny; one intra-op thread keeps them
    off a busy host's thread pool. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _histories():
    """5-process valid and mutated histories, two 8-process histories
    with up to 8 calls in flight that overflow 128 configs, in the
    middle of the batch."""
    rng = random.Random(5)
    hs = []
    for i in range(6):
        h = JS.register_history(rng, n_procs=5, n_events=120, values=5,
                                p_info=0.0)
        if i % 2:
            h = JS.mutate(rng, h, values=5)
        hs.append(h)
    for seed in (0, 2):
        hs.insert(3, JS.register_history(random.Random(seed), n_procs=8,
                                         n_events=160, values=5,
                                         p_info=0.0, max_pending=8))
    return hs


def _malformed(O, pack):
    bad = [O.invoke(0, "write", 1), O.invoke(0, "write", 2),
           O.ok(0, "write", 2)]
    return pack([op.with_(index=i) for i, op in enumerate(bad)],
                completed=True)


@pytest.fixture(scope="module")
def batches():
    hs = _histories()
    jb = JB.pack_batch(hs + [_malformed(JO, jax_pack)], JM.cas_register())
    tb = TB.pack_batch(hs + [_malformed(TO, torch_pack)],
                       TM.cas_register())
    return jb, tb


@pytest.fixture(scope="module")
def jax_keys(batches):
    jb, _ = batches
    return JB.check_batch(jb, F=512, engine="keys")


def test_pack_batch_arrays_are_byte_equal(batches):
    jb, tb = batches
    for f in ("kind", "proc", "tr"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jb.P == tb.P
    assert [r.tolist() for r in jb.remaps] == \
        [r.tolist() for r in tb.remaps]
    assert np.array_equal(jb.memo.succ, tb.memo.succ)
    sj, st = JB.segment_batch(jb), TB.segment_batch(tb)
    for f in ("inv_proc", "inv_tr", "ok_proc", "seg_index", "depth"):
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_renamed_streams_and_remap_slots_batch_are_byte_equal(batches):
    jb, tb = batches
    (sj, pj), (st, pt) = JB._stream_segments(jb), TB._stream_segments(tb)
    assert pj == pt
    for a, b in zip(sj, st):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    raw = [LJ.make_segments(p) for p in jb.packeds[:-1]]
    (rj, ej), (rt, et) = (LJ.remap_slots_batch(raw),
                          LT.remap_slots_batch(raw))
    assert ej == et
    for a, b in zip(rj, rt):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_pack_stream_rows_and_starts_are_byte_equal(batches):
    jb, tb = batches
    streams, p_eff = JB._stream_segments(jb)
    sizes = dict(n_states=jb.memo.n_states,
                 n_transitions=jb.memo.n_transitions)
    spec_j = JB._slice_spec(streams, sizes, 0)
    spec_t = TB._slice_spec(TB._stream_segments(tb)[0], sizes)
    assert (spec_t.P, spec_t.K, spec_t.n_words) == \
        (spec_j.P, spec_j.K, spec_j.n_words)
    chunks, starts_j = PS.pack_stream(streams, spec_j)
    rows, starts_t = SK.pack_stream(streams, spec_t, chunk=spec_j.chunk)
    assert rows.dtype == chunks.dtype
    assert np.array_equal(rows, chunks.reshape(-1, rows.shape[1]))
    assert np.array_equal(starts_t, starts_j)
    # unchunked: the same rows, cut after the trailing RESET
    rows1, _ = SK.pack_stream(streams, spec_t)
    assert np.array_equal(rows1, rows[:rows1.shape[0]])
    assert rows1[-1, 0] == SK.RESET == -2


@pytest.mark.parametrize("B,n_dev,cap", [(0, 0, 8), (5, 0, 8),
                                         (17, 0, 8), (17, 3, 8),
                                         (4096, 0, 512), (9, 4, 2048)])
def test_plan_stream_slices_matches(B, n_dev, cap):
    assert SK.plan_stream_slices(B, n_dev, max_stream_b=cap) == \
        PS.plan_stream_slices(B, n_dev, max_stream_b=cap)


def test_plan_stream_slices_default_is_one_slice():
    assert SK.plan_stream_slices(4096, 0) == [(0, 4096, 0)]


def test_merge_stream_slice_matches():
    rng = np.random.default_rng(1)
    res = rng.integers(-1, 50, (8, 128)).astype(np.int32)
    starts = np.array([1, 5, 9, 20, 22, 30, 31, 40], np.int64)
    assert SK.merge_stream_slice(res, starts, 8) == \
        PS.merge_stream_slice(res, starts, 8)


def test_escalation_helpers_match():
    st = np.array([0, 2, 1, 2, 0], np.int32)
    for F in (64, 128, 256):
        assert np.array_equal(TB.escalation_indices(st, F, 128),
                              JB.escalation_indices(st, F, 128))
    args = (st, np.arange(5), np.ones(5, np.int32), np.array([1, 3]),
            np.array([0, 1]), np.array([-1, 7]), np.array([9, 4]))
    for a, b in zip(TB.merge_escalation(*args),
                    JB.merge_escalation(*args)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_keys_engine_is_bit_equal(batches, jax_keys):
    _, tb = batches
    info = {}
    got = TB.check_batch(tb, F=512, engine="keys", device="cpu",
                         info=info)
    assert info["engine"] == "keys"
    for a, b in zip(got, jax_keys):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    st = jax_keys[0].tolist()
    assert st[-1] == LT.UNKNOWN and LT.INVALID in st
    assert st[:-1].count(LT.UNKNOWN) == 0


def test_stream_engine_matches_the_jax_keys_engine(batches, jax_keys):
    _, tb = batches
    info = {}
    st, fa, n = TB.check_batch(tb, F=512, device="cpu", info=info)
    assert info["engine"] == "stream"
    assert info["escalated"] == {"engine": "keys", "count": 2}
    assert info["stream"]["groups"] == len(tb)
    js, jf, jn = jax_keys
    assert st.tolist() == js.tolist() and fa.tolist() == jf.tolist()
    for s, a, b in zip(st.tolist(), n.tolist(), jn.tolist()):
        assert a == (0 if s == LT.INVALID else b)


def test_ten_process_lanes_escalate_through_mxu():
    """10-process lanes (up to 10 calls in flight) overflow the kernel's
    128 configs; their slot count rounds up to 16, so the escalation
    runs the MXU engine, not the keys engine, and every lane still gets
    the verdict of its own single-history ``analysis`` (the seg2 ladder
    at the same capacity bound)."""
    from comdb2_tpu_torch.checker import analysis
    rng = random.Random(5)
    hs = []
    for i in range(3):
        h = JS.register_history(rng, n_procs=5, n_events=120, values=5,
                                p_info=0.0)
        hs.append(JS.mutate(rng, h, values=5) if i == 1 else h)
    for seed in (77, 79, 80):
        hs.insert(1, JS.register_history(random.Random(seed), n_procs=10,
                                         n_events=120, values=5,
                                         p_info=0.0, max_pending=10))
    tb = TB.pack_batch(hs, TM.cas_register())
    info = {}
    st, fa, _ = TB.check_batch(tb, F=1024, device="cpu", info=info)
    assert info["engine"] == "stream"
    assert info["escalated"] == {"engine": "mxu", "count": 3}
    for i, h in enumerate(hs):
        a = analysis(TM.cas_register(), h, device="cpu", backend="device",
                     capacities=(256, 1024))
        want = ({True: LT.VALID, False: LT.INVALID}.get(a.valid,
                                                          LT.UNKNOWN),
                -1 if a.valid is True else a.op_index)
        assert (int(st[i]), int(fa[i])) == want, i


def _renamed(seed_list):
    out = []
    for kw, mutate in seed_list:
        rng = random.Random(kw.pop("seed"))
        h = JS.register_history(rng, **kw)
        if mutate:
            h = JS.mutate(rng, h, values=5)
        out.append(torch_pack(h))
    return out


def test_stream_groups_carry_on_past_invalid_and_overflow():
    packeds = _renamed(
        [(dict(seed=s, n_procs=5, n_events=100, values=5, p_info=0.0),
          m) for s, m in ((11, False), (12, False), (13, True))]
        + [(dict(seed=0, n_procs=8, n_events=160, values=5, p_info=0.0,
                 max_pending=8), False)]
        + [(dict(seed=s, n_procs=5, n_events=100, values=5, p_info=0.0),
            False) for s in (14, 15, 16, 17)])
    tb = TB.pack_batch(packeds, TM.cas_register())
    streams, p_eff = TB._stream_segments(tb)
    sizes = dict(n_states=tb.memo.n_states,
                 n_transitions=tb.memo.n_transitions)
    spec = TB._slice_spec(streams, sizes)
    info = {}
    got = SK.stream_dispatch(tb.memo.succ, streams, spec, device="cpu",
                             groups=2, info=info, **sizes)
    assert info["groups"] == 2 and info["max_per_group"] >= 4
    want = [SK.check_device_seg_kernel(tb.memo.succ, s, P=spec.P,
                                       device="cpu", **sizes)
            for s in streams]
    assert [tuple(r) for r in got] == [tuple(w) for w in want]
    status = [w[0] for w in want]
    assert status[2] == LT.INVALID and status[3] == LT.UNKNOWN
    assert status[4:] == [LT.VALID] * 4


def test_plan_groups_balances_by_segments():
    sizes = [100, 5, 90, 7, 50, 50, 3, 1]
    plan = SK.plan_groups(sizes, 3)
    assert sorted(b for g in plan for b in g) == list(range(8))
    loads = [sum(sizes[b] + 1 for b in g) for g in plan]
    assert max(loads) - min(loads) <= max(sizes)
    wide = SK.plan_groups(sizes, 100)
    assert len(wide) == 8 and all(len(g) == 1 for g in wide)


PADS = dict(s_pad=512, k_pad=16, n_states_pad=32, n_transitions_pad=32,
            p_eff_pad=8)


@pytest.fixture(scope="module")
def jax_keys_padded(batches):
    jb, _ = batches
    return JB.check_batch(jb, F=512, engine="keys", **PADS)


@pytest.mark.parametrize("engine", ["keys", "auto"])
def test_pad_floors_change_no_verdict(batches, jax_keys, jax_keys_padded,
                                      engine):
    """The reference's shape floors, non-zero: the same verdicts as the
    JAX package with the same floors (and as without them)."""
    _, tb = batches
    got = TB.check_batch(tb, F=512, engine=engine, device="cpu", **PADS)
    for a, b, c in zip(got[:2], jax_keys_padded[:2], jax_keys[:2]):
        assert a.tolist() == b.tolist() == c.tolist()
    st = got[0].tolist()
    for s, a, b in zip(st, got[2].tolist(), jax_keys_padded[2].tolist()):
        # the stream kernel zeroes its count on INVALID (see the module
        # note); the key engines keep the pre-death one
        assert a == (0 if s == LT.INVALID and engine == "auto" else b)


@pytest.mark.parametrize("n_pad,s_pad,k_pad", [(0, 0, 0), (1024, 256, 16),
                                               (64, 4096, 2)])
def test_pad_floors_shape_the_host_arrays_alike(n_pad, s_pad, k_pad):
    hs = _histories()[:3]
    jb = JB.pack_batch(hs, JM.cas_register(), n_pad=n_pad)
    tb = TB.pack_batch(hs, TM.cas_register(), n_pad=n_pad)
    for f in ("kind", "proc", "tr"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    sj = JB.segment_batch(jb, s_pad=s_pad, k_pad=k_pad)
    st = TB.segment_batch(tb, s_pad=s_pad, k_pad=k_pad)
    for f in ("inv_proc", "inv_tr", "ok_proc", "seg_index", "depth"):
        a, b = getattr(sj, f), getattr(st, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _assert_lanes_equal(got, want):
    """Status and fail index bit-equal; n_final equal on VALID lanes."""
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
    valid = want[0] == LT.VALID
    assert got[2][valid].tolist() == want[2][valid].tolist()


@pytest.mark.parametrize("route", ["flat", "vmap", "mesh"])
def test_unported_routes_raise(batches, route):
    """Only ``mesh=`` still raises (the mesh routes are not ported).
    ``engine="flat"`` and ``engine="vmap"``, which raised until their
    engines were ported, give the JAX package's verdicts at the same F
    on the mixed batch (the malformed lane unknown)."""
    jb, tb = batches
    if route == "mesh":
        with pytest.raises(EngineNotPorted):
            TB.check_batch(tb, device="cpu", mesh=object())
        return
    info, jinfo = {}, {}
    got = TB.check_batch(tb, F=512, engine=route, info=info, device="cpu")
    want = JB.check_batch(jb, F=512, engine=route, info=jinfo)
    _assert_lanes_equal(got, want)
    assert info["engine"] == jinfo["engine"] == route
    assert info["engine_stats"]["closure_iterations"] > 0
    assert got[0][-1] == LT.UNKNOWN


def _vmap_only_histories():
    """Eight-process lanes over 20 values: the union table has 77
    transitions, so neither the 62-bit key layout nor the flat budget
    fits at P = 8 and the MXU engine does not serve P < 16 — only vmap
    does. Every third lane is mutated; lane 1 has up to 8 calls in
    flight and overflows the kernel's 128 configs."""
    rng = random.Random(11)
    hs = []
    for i in range(8):
        h = JS.register_history(rng, n_procs=8, n_events=250, values=20,
                                p_info=0.0, max_pending=3)
        hs.append(JS.mutate(rng, h, values=20) if i % 3 == 1 else h)
    hs.insert(1, JS.register_history(random.Random(2), n_procs=8,
                                     n_events=250, values=20, p_info=0.0,
                                     max_pending=8))
    return hs


@pytest.fixture(scope="module")
def vmap_only():
    hs = _vmap_only_histories()
    jb = JB.pack_batch(hs, JM.cas_register())
    tb = TB.pack_batch(hs, TM.cas_register())
    jinfo = {}
    want = JB.check_batch(jb, F=512, engine="auto", info=jinfo)
    return hs, jb, tb, want, jinfo


def test_vmap_only_shape_is_vmap_only(vmap_only):
    _, jb, tb, _, jinfo = vmap_only
    m = tb.memo
    assert (m.n_states, m.n_transitions) == (jb.memo.n_states,
                                             jb.memo.n_transitions)
    assert TB.pick_engine(len(tb), m.n_states, m.n_transitions, 8) == "vmap"
    # on CPU the JAX package has no fused kernel: its auto takes vmap
    assert jinfo["engine"] == "vmap"


@pytest.mark.parametrize("engine", ["vmap", "auto"])
def test_vmap_only_shape_matches_the_reference(vmap_only, engine):
    """``auto`` runs the stream kernel (its plain version here) and
    escalates the lane that overflowed 128 configs through vmap at F;
    ``vmap`` runs every lane through it. Both give the JAX package's
    verdicts."""
    _, _, tb, want, _ = vmap_only
    info = {}
    got = TB.check_batch(tb, F=512, engine=engine, info=info, device="cpu")
    _assert_lanes_equal(got, want)
    if engine == "auto":
        assert info["engine"] == "stream"
        assert info["escalated"]["engine"] == "vmap"
        assert info["escalated"]["count"] == 1
        assert info["escalated"]["engine_stats"]["host_syncs"] > 0
    else:
        assert info["engine"] == "vmap"
    assert {LT.VALID, LT.INVALID} <= set(got[0].tolist())


def test_vmap_only_shape_refuses_flat(vmap_only):
    _, _, tb, _, _ = vmap_only
    with pytest.raises(ValueError, match="budget"):
        TB.check_batch(tb, F=512, engine="flat", device="cpu")


def test_vmap_needs_the_step_streams(vmap_only):
    hs = vmap_only[0]
    tb = TB.pack_batch(hs, TM.cas_register(), build_streams=False)
    with pytest.raises(ValueError, match="build_streams"):
        TB.check_batch(tb, F=512, engine="vmap", device="cpu")


def test_escalation_without_step_streams_stays_unknown(vmap_only):
    """Packed without the dense step streams, a kernel overflow that
    only vmap could take stays unknown, and ``info`` says the
    escalation was asked for and impossible (the JAX package's
    contract)."""
    hs, _, _, want, _ = vmap_only
    tb = TB.pack_batch(hs, TM.cas_register(), build_streams=False)
    info = {}
    st, fa, _ = TB.check_batch(tb, F=512, info=info, device="cpu")
    assert info["escalated"] == {"engine": None, "count": 1}
    assert st[1] == LT.UNKNOWN
    others = [i for i in range(len(hs)) if i != 1]
    assert st[others].tolist() == want[0][others].tolist()
    assert fa[others].tolist() == want[1][others].tolist()


@pytest.mark.parametrize("fn", [TB.check_batch, TB.check_batch_async])
def test_unknown_pad_keyword_raises(batches, fn):
    """The reference's table and slot floors are the only extra keywords
    the batch entry points take; a misspelt one raises."""
    _, tb = batches
    assert set(TB.REFERENCE_PADS) == {k for k in PADS if k not in
                                      ("s_pad", "k_pad")}
    with pytest.raises(TypeError, match="p_eff_padd"):
        fn(tb, F=512, engine="keys", device="cpu", p_eff_padd=8)
