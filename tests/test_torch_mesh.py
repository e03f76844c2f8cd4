"""The port's mesh routes against the JAX package's 8-device CPU mesh.

A port mesh is a power-of-two tuple of devices
(``service.sharding.make_mesh(D, device="cpu")`` here: D CPU slots, one
independent call per slot, the kernels as their plain versions); the
JAX package's is a ``jax.sharding.Mesh`` over D of the CPU devices that
``tests/conftest.py`` sets up. Held exactly (integer verdicts):
``check_batch(mesh=)`` for D = 2, 4, 8 — verdicts, fail indices,
``info["engine"]`` labels (``keys-sharded`` / ``flat-sharded`` /
``stream-sharded``, ``mesh_dropped`` for mxu and vmap) and the
sentinel-padded ``info["batch"]``; ``plan_shard_slices`` /
``merge_stream_shards``; ``closure_diag_batch(mesh=)``;
``IndependentChecker(mesh=)``; ``check_histories_sharded``; the sharded
launch (``stream_dispatch_sharded``) against one launch. Also: a
staged ``check_batch_async`` over more than ``PIPELINE_B`` histories
gives ``check_batch``'s arrays.
"""

import random

import numpy as np
import pytest
import torch

import histgen
from comdb2_tpu.checker import batch as JB
from comdb2_tpu.checker import pallas_seg as PSEG
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import op as JO

from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.service import sharding as TS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(d):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:d]), ("batch",))


def _tmesh(d):
    return TS.make_mesh(d, device="cpu")


def _mixed_histories(n, seed=72_000):
    """The reference suite's mixed batch: 2-4 processes, 6-28 events,
    every other history mutated, some with :info ops."""
    hs = []
    for i in range(n):
        rng = random.Random(seed + i)
        h = histgen.register_history(
            rng, n_procs=rng.randint(2, 4), n_events=rng.randint(6, 28),
            p_info=0.1 if i % 3 == 0 else 0.0)
        if i % 2:
            h = histgen.mutate(rng, h)
        hs.append(h)
    return hs


def _both(hs):
    return (JB.pack_batch(hs, JM.cas_register()),
            TB.pack_batch(hs, TM.cas_register()))


def _equal(got, want):
    for a, b in zip(got, want):
        assert np.asarray(a).tolist() == np.asarray(b).tolist()


# --- pure planning helpers -----------------------------------------------------

@pytest.mark.parametrize("B,D,cap", [(8, 2, 512), (16, 4, 2), (64, 8, 3),
                                     (8, 8, 1), (1024, 2, 512)])
def test_plan_shard_slices_equal(B, D, cap):
    assert SK.plan_shard_slices(B, D, max_stream_b=cap) == \
        PSEG.plan_shard_slices(B, D, max_stream_b=cap)


def test_plan_shard_slices_rejects_a_ragged_batch():
    for fn in (SK.plan_shard_slices, PSEG.plan_shard_slices):
        with pytest.raises(ValueError, match="multiple"):
            fn(6, 4, max_stream_b=8)


def test_merge_stream_shards_equal():
    rng = np.random.default_rng(3)
    D, g = 4, 3
    res = rng.integers(-1, 40, (D, g, 3)).astype(np.int32)
    starts = [np.sort(rng.integers(0, 20, g)) for _ in range(D)]
    # the JAX package's results tile is (D, b_pad, 128): same rows
    jres = np.zeros((D, 8, 128), np.int32)
    jres[:, :g, :3] = res
    assert SK.merge_stream_shards(res, starts, D * g, D) == \
        PSEG.merge_stream_shards(jres, starts, D * g, D)


def test_stream_dispatch_sharded_matches_one_launch():
    """The sharded launch of B histories over D slots, decoded by
    ``merge_stream_shards``, gives every history the verdict of the one
    launch over all of them."""
    _, tb = _both(_mixed_histories(8, seed=6_000))
    streams, _ = TB._stream_segments(tb)
    sizes = {"n_states": tb.memo.n_states,
             "n_transitions": tb.memo.n_transitions}
    spec = TB._slice_spec(streams, sizes)
    one = SK.stream_dispatch(tb.memo.succ, streams, spec, **sizes,
                             device="cpu")
    for D in (2, 4):
        res, starts = SK.stream_dispatch_sharded(tb.memo.succ, streams,
                                                 spec, **sizes,
                                                 mesh=_tmesh(D))
        assert res.shape == (D, 8 // D, 3)
        assert SK.merge_stream_shards(res, starts, 8, D) == one


def test_make_mesh():
    assert TS.make_mesh(4, device="cpu") == (torch.device("cpu"),) * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.make_mesh(1)
    assert TS.shard_fill(5, 8, 4) == [1.0, 1.0, 0.5, 0.0]


# --- check_batch(mesh=) --------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    return _both(_mixed_histories(11, seed=90_000))


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("engine", ["keys", "flat"])
def test_sharded_engines_match(mixed, engine, D):
    """B = 11 pads to 16 sentinel lanes: every D gives the reference's
    verdicts and labels, and the unsharded run's verdicts."""
    jb, tb = mixed
    info, jinfo = {}, {}
    got = TB.check_batch(tb, F=64, engine=engine, mesh=_tmesh(D),
                         info=info)
    want = JB.check_batch(jb, F=64, engine=engine, mesh=_jmesh(D),
                          info=jinfo)
    _equal(got, want)
    _equal(got, TB.check_batch(tb, F=64, engine=engine, device="cpu"))
    assert info["engine"] == jinfo["engine"] == f"{engine}-sharded"
    assert info["batch"] == jinfo["batch"] == {
        "b": 11, "b_pad": 16, "pad": 5, "shards": D}


def test_sharded_keys_against_the_sharded_vmap_oracle(mixed):
    """``check_sharded`` (the per-op engine split over the mesh, a test
    oracle only, as in the JAX package) agrees with the sharded keys
    engine and with the JAX package's oracle."""
    from comdb2_tpu.checker import linear_jax as LJ

    jb, tb = mixed
    keys = TB.check_batch(tb, F=64, engine="keys", mesh=_tmesh(4))
    kind, proc, tr = (np.concatenate([a, a[:5]]) for a in
                      (tb.kind, tb.proc, tb.tr))    # 16 lanes for D = 4
    sizes = {"n_states": tb.memo.n_states,
             "n_transitions": tb.memo.n_transitions}
    P = max(2, 1 << (tb.P - 1).bit_length())
    got = LT.check_sharded(_tmesh(4), tb.memo.succ, kind, proc, tr, F=64,
                           P=P, **sizes)
    want = LJ.check_sharded(_jmesh(4), jb.memo.succ, kind, proc, tr, F=64,
                            P=P, **sizes)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    # malformed-free lanes: the oracle's verdicts are the keys engine's
    assert got[0][:11].tolist() == keys[0].tolist()


@pytest.mark.parametrize("engine", ["mxu", "vmap"])
def test_unsharded_engines_drop_the_mesh(engine):
    """mxu and vmap have no sharded form: a mesh caller runs on one
    device and ``mesh_dropped`` says so, in both packages."""
    rng = random.Random(8)
    n_procs = 9 if engine == "mxu" else 3
    hs = [histgen.register_history(rng, n_procs=n_procs, n_events=30,
                                   p_info=0.0) for _ in range(3)]
    hs[1] = histgen.mutate(rng, hs[1])
    jb, tb = _both(hs)
    info, jinfo = {}, {}
    got = TB.check_batch(tb, F=64, engine=engine, mesh=_tmesh(4),
                         info=info)
    want = JB.check_batch(jb, F=64, engine=engine, mesh=_jmesh(4),
                          info=jinfo)
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
    assert info["engine"] == jinfo["engine"] == engine
    assert info["mesh_dropped"] is jinfo["mesh_dropped"] is True


def test_non_pow2_mesh_rejected(mixed):
    _, tb = mixed
    with pytest.raises(ValueError, match="power of two"):
        TB.check_batch(tb, F=64, engine="keys", mesh=_tmesh(3))


@pytest.fixture()
def interpret_kernel():
    PSEG.use_interpret(True)
    yield
    PSEG.use_interpret(False)


def test_stream_sharded_matches(interpret_kernel):
    """The stream route over 8 slots (one launch per slot) against the
    JAX package's sharded kernel in interpret mode: the same verdicts,
    the same ``stream-sharded`` label; a history that overflows the
    kernel's 128 configs escalates on its shard in both."""
    rng = random.Random(13)
    hs = [histgen.register_history(rng, n_procs=4, n_events=24,
                                   p_info=0.0) for _ in range(6)]
    hs[2] = histgen.mutate(rng, hs[2])
    k = 6                                   # 193-config closure
    hs.append([JO.invoke(p, "write", p) for p in range(k)]
              + [JO.ok(p, "write", p) for p in range(k)])
    jb, tb = _both(hs)
    info, jinfo = {}, {}
    got = TB.check_batch(tb, F=256, engine="stream", mesh=_tmesh(8),
                         info=info)
    want = JB.check_batch(jb, F=256, engine="stream", mesh=_jmesh(8),
                          info=jinfo)
    _equal(got[:2], want[:2])
    ok = want[0] == LT.VALID
    assert got[2][ok].tolist() == want[2][ok].tolist()
    assert info["engine"] == jinfo["engine"] == "stream-sharded"
    assert info["escalated"]["count"] == jinfo["escalated"]["count"] == 1
    assert info["stream"]["launches"] == 8     # one per slot


def test_one_device_mesh_is_the_plain_stream_route():
    hs = _mixed_histories(5)
    _, tb = _both(hs)
    info = {}
    got = TB.check_batch(tb, F=128, engine="stream", mesh=_tmesh(1),
                         info=info)
    assert info["engine"] == "stream"
    _equal(got, TB.check_batch(tb, F=128, engine="stream", device="cpu"))


# --- the other mesh surfaces ---------------------------------------------------

@pytest.mark.parametrize("D", [2, 4, 8])
def test_closure_mesh_matches(D):
    from comdb2_tpu.txn import closure_jax as JCJ
    from comdb2_tpu_torch.txn import closure_torch as TCJ

    rng = np.random.default_rng(11 + D)
    B, N = 5, 32
    adjs = np.zeros((B, 4, N, N), bool)
    for b in range(B):
        for _ in range(int(rng.integers(4, 40))):
            i, j = rng.integers(0, N, 2)
            if i != j:
                adjs[b, int(rng.integers(0, 3)), i, j] = True
    got = TCJ.closure_diag_batch(adjs, mesh=_tmesh(D))
    want = JCJ.closure_diag_batch(adjs, mesh=_jmesh(D))
    assert got.shape == (B, 3, N)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_independent_checker_mesh_matches(D):
    from comdb2_tpu.checker import checkers as JC
    from comdb2_tpu.checker import independent as JI
    from comdb2_tpu_torch.checker import checkers as TC
    from comdb2_tpu_torch.checker import independent as TI

    def keyed(O, key):
        rng = random.Random(21)
        h = []
        for k in range(5):
            sub = histgen.register_history(rng, n_procs=3, n_events=16,
                                           p_info=0.0)
            if k == 3:
                sub = histgen.mutate(rng, sub)
            h += [O.Op(op.process + 10 * k, op.type, op.f,
                       key(k, op.value)) for op in sub]
        return h

    got = TI.IndependentChecker(TC.Linearizable(device="cpu"),
                                mesh=_tmesh(D)).check(
        {"name": "t"}, TM.cas_register(), keyed(TO, TI.tuple_))
    want = JI.IndependentChecker(JC.Linearizable(), mesh=_jmesh(D)).check(
        {"name": "t"}, JM.cas_register(), keyed(JO, JI.tuple_))
    assert got["valid?"] == want["valid?"]
    assert got["failures"] == want["failures"]
    assert {k: v["valid?"] for k, v in got["results"].items()} == \
        {k: v["valid?"] for k, v in want["results"].items()}


def test_check_histories_sharded_matches():
    from comdb2_tpu.service import sharding as JS

    hs = _mixed_histories(6, seed=5_000)
    got = TS.check_histories_sharded(hs, TM.cas_register(),
                                     mesh=_tmesh(4), F=64)
    want = JS.check_histories_sharded(hs, JM.cas_register(),
                                      mesh=_jmesh(4), F=64)
    _equal(got[:2], want[:2])
    empty = TS.check_histories_sharded([], TM.cas_register(),
                                       mesh=_tmesh(2))
    assert [a.size for a in empty] == [0, 0, 0]


# --- staging ---------------------------------------------------------------------

def test_staged_async_beyond_pipeline_b():
    """A batch of PIPELINE_B + 9 histories stages in two slices (the
    second launched after the first, before any readback) and finalizes
    to the arrays of the same batch checked from its cached streams, in
    one launch."""
    rng = random.Random(77)
    hs = []
    for i in range(TB.PIPELINE_B + 9):
        h = histgen.register_history(rng, n_procs=2, n_events=6,
                                     p_info=0.0)
        hs.append(histgen.mutate(rng, h) if i % 50 == 7 else h)
    tb = TB.pack_batch(hs, TM.cas_register())
    info: dict = {}
    fin = TB.check_batch_async(tb, F=128, engine="stream", info=info,
                               device="cpu")
    assert fin.ready()          # the plain versions ran in the stage
    assert [(s["start"], s["end"]) for s in info["stream"]["slices"]] == \
        [(0, TB.PIPELINE_B), (TB.PIPELINE_B, TB.PIPELINE_B + 9)]
    got = fin()
    # the cached streams now serve a second run, in one launch
    info_again: dict = {}
    again = TB.check_batch(tb, F=128, engine="stream", info=info_again,
                           device="cpu")
    assert [(s["start"], s["end"]) for s in
            info_again["stream"]["slices"]] == [(0, TB.PIPELINE_B + 9)]
    _equal(got, again)
    tk = TB.pack_batch(hs, TM.cas_register())
    keys = TB.check_batch(tk, F=128, engine="keys", device="cpu")
    _equal(got[:2], keys[:2])
    assert (got[0] == LT.INVALID).sum() > 0
