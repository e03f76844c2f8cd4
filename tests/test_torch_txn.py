"""The port's serializability checker (``comdb2_tpu_torch.txn``) against
the JAX package's (``comdb2_tpu.txn``).

- Edge inference: the same history gives bit-equal (4, n, n) planes,
  labels, version orders and direct anomalies, on the fixtures and on
  seeded ``list_append_history`` runs (whose generator is the same
  draw for draw in both packages).
- The closure: ``closure_diag`` / ``closure_diag_batch`` on CPU tensors
  give the same diagonal as ``closure_jax`` (jit on the CPU) and as the
  host SCC, at N = 16, 64 and 128, with the realtime plane on and off,
  and all-zero pad lanes read all False; the JAX package's graph feeds
  the port's closure through ``convert.txn_planes``.
- ``check_txn``: the verdict map, decoded counterexample included, on
  the three fixtures and on ``txn_anomaly_history`` for every kind,
  host and device backends, realtime on and off.

No tolerance: every value compared is a bool, an int or a string.
"""

import os
import random

import numpy as np
import pytest
import torch

from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.history import parse_history as jax_parse
from comdb2_tpu.txn import check_txn as jax_check_txn
from comdb2_tpu.txn import closure_jax as JC
from comdb2_tpu.txn import infer_edges as jax_infer_edges

from comdb2_tpu_torch import convert
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.history import parse_history
from comdb2_tpu_torch.txn import check as TCHECK
from comdb2_tpu_torch.txn import check_txn, infer_edges
from comdb2_tpu_torch.txn import closure_torch as TC
from comdb2_tpu_torch.txn.scc import cyclic_layers_host

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "txn")
FIXTURES = ("clean", "g1c", "g2_item")
KINDS = ("clean", "g0", "g1c", "g1a", "g2-item", "duplicate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(name):
    with open(os.path.join(FIXDIR, f"{name}.edn")) as fh:
        text = fh.read()
    return parse_history(text), jax_parse(text)


def _plain(x):
    """Ops (of either package) as their maps, so values compare across
    the packages' classes."""
    if hasattr(x, "to_map") and hasattr(x, "process"):
        return x.to_map()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x) if not hasattr(x, "_fields") \
            else tuple(_plain(v) for v in x)
    return x


def _same_graph(g, jg):
    assert g.n == jg.n
    assert np.array_equal(g.adj, jg.adj)
    assert np.array_equal(g.padded(), jg.padded())
    assert g.labels == jg.labels
    assert g.orders == jg.orders
    assert _plain(g.anomalies) == _plain(jg.anomalies)
    assert [(t.index, t.invoke_at, t.complete_at, t.status, t.mops,
             t.dirty) for t in g.txns] == \
        [(t.index, t.invoke_at, t.complete_at, t.status, t.mops, t.dirty)
         for t in jg.txns]


def _list_append(seed, **kw):
    kw = {"n_procs": 4, "n_txns": 40, "n_keys": 3, "p_info": 0.1,
          "p_fail": 0.15, **kw}
    return (TS.list_append_history(random.Random(seed), **kw),
            JS.list_append_history(random.Random(seed), **kw))


# --- edge inference -----------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("realtime", [False, True])
def test_edges_equal_on_fixtures(name, realtime):
    h, jh = _fixture(name)
    _same_graph(infer_edges(h, realtime=realtime),
                jax_infer_edges(jh, realtime=realtime))


@pytest.mark.parametrize("seed", range(4))
def test_edges_equal_on_list_append_histories(seed):
    h, jh = _list_append(seed)
    assert [op.to_map() for op in h] == [op.to_map() for op in jh]
    _same_graph(infer_edges(h, realtime=True),
                jax_infer_edges(jh, realtime=True))


# --- the closure -------------------------------------------------------------

def _planes(seed, n):
    """(4, n, n) planes: acyclic ww and wr (upper triangle) with a back
    edge closing a G0 cycle on seeds = 0 mod 3 and a G1c cycle on
    seeds = 1 mod 3, rw anywhere (G2 cycles), rt upper triangle."""
    rng = np.random.default_rng(seed)
    up = np.triu(np.ones((n, n), bool), 1)
    adj = np.zeros((4, n, n), bool)
    adj[0] = up & (rng.random((n, n)) < 2 / n)
    adj[1] = up & (rng.random((n, n)) < 2 / n)
    adj[2] = rng.random((n, n)) < 0.7 / n
    adj[3] = up & (rng.random((n, n)) < 4 / n)
    i = int(rng.integers(n // 2, n))
    adj[0, i - 1, i] = adj[1, i - 2, i - 1] = True
    if seed % 3 == 0:
        adj[0, i, i - 1] = True
    elif seed % 3 == 1:
        adj[1, i, i - 2] = True
    for p in range(4):
        np.fill_diagonal(adj[p], False)
    return adj


@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("realtime", [False, True])
def test_closure_diag_equals_closure_jax_and_host_scc(n, realtime):
    for seed in range(3):
        adj = _planes(seed + n, n)
        padded = adj.copy()
        if not realtime:
            padded[3] = False
        before = TC.DISPATCHES
        got = TC.closure_diag(padded, device="cpu")
        assert TC.DISPATCHES == before + 1
        assert got.dtype == bool and got.shape == (3, n)
        assert np.array_equal(got, np.asarray(JC.closure_diag(padded)))
        assert np.array_equal(got, cyclic_layers_host(adj, realtime))
        assert np.array_equal(
            TC.cyclic_layers_device(adj, realtime, device="cpu"),
            cyclic_layers_host(adj, realtime))
        # the reference's graph object through convert
        assert np.array_equal(
            convert.txn_planes(padded, "cpu").numpy(), padded)
    assert got[2].any()


def test_closure_diag_batch_with_zero_pad_lanes():
    n = 64
    adjs = np.zeros((8, 4, n, n), bool)
    for b in range(5):
        adjs[b] = _planes(100 + b, n)
    before = TC.DISPATCHES
    got = TC.closure_diag_batch(adjs, device="cpu")
    assert TC.DISPATCHES == before + 1
    assert got.shape == (8, 3, n)
    assert np.array_equal(got, np.asarray(JC.closure_diag_batch(adjs)))
    for b in range(5):
        assert np.array_equal(got[b], cyclic_layers_host(adjs[b], True))
    assert not got[5:].any()
    fin = TC.closure_diag_batch_async(adjs, device="cpu")
    assert np.array_equal(fin(), got)


def test_closure_of_the_reference_graph():
    h, jh = _list_append(7)
    jg = jax_infer_edges(jh + JS.txn_anomaly_history("g2-item"))
    planes = convert.txn_planes(jg.padded(), "cpu").numpy()
    got = TC.closure_diag(planes, device="cpu")
    assert np.array_equal(got, np.asarray(JC.closure_diag(jg.padded())))
    assert got[2].any()


def test_closure_mesh_route_is_not_ported():
    """The mesh route, which raised until it was ported: three graphs
    over a two-slot CPU mesh (padded to four, one call per slot) give
    the JAX package's sharded closure over two CPU devices."""
    import jax
    from jax.sharding import Mesh

    from comdb2_tpu.txn import closure_jax as JCJ
    from comdb2_tpu_torch.service.sharding import make_mesh

    rng = np.random.default_rng(4)
    adjs = rng.random((3, 4, 16, 16)) < 0.08
    d0 = TC.DISPATCHES
    got = TC.closure_diag_batch(adjs, mesh=make_mesh(2, device="cpu"))
    assert TC.DISPATCHES - d0 == 2            # one call per device
    want = JCJ.closure_diag_batch(
        adjs, mesh=Mesh(np.asarray(jax.devices()[:2]), ("batch",)))
    assert got.shape == want.shape == (3, 3, 16)
    assert np.array_equal(got, want)
    assert np.array_equal(got, TC.closure_diag_batch(adjs, device="cpu"))


def test_squarings_reach_a_path_of_every_length():
    """A single n-cycle needs every one of the ceil(log2 n) squarings."""
    for n in (16, 64):
        adj = np.zeros((4, n, n), bool)
        for v in range(n):
            adj[2, v, (v + 1) % n] = True
        got = TC.closure_diag(adj, device="cpu")
        assert got[2].all() and not got[:2].any()
        assert TC.squarings(n) == (n - 1).bit_length()


# --- check_txn ---------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("backend", ["host", "device"])
def test_check_txn_equal_on_fixtures(name, backend):
    h, jh = _fixture(name)
    got = check_txn(h, backend=backend, device="cpu")
    assert got == jax_check_txn(jh, backend=backend)
    assert got["valid?"] is (name == "clean")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("realtime", [False, True])
def test_check_txn_equal_on_every_anomaly_kind(kind, realtime):
    h, jh = TS.txn_anomaly_history(kind), JS.txn_anomaly_history(kind)
    want = jax_check_txn(jh, backend="host", realtime=realtime)
    for backend in ("host", "device"):
        got = check_txn(h, backend=backend, realtime=realtime,
                        device="cpu")
        assert got == want, backend
    assert got["valid?"] is (kind == "clean")


@pytest.mark.parametrize("kind", ["g1c", "g2-item"])
def test_check_txn_equal_on_a_run_with_an_anomaly_appended(kind):
    """A generated run with the anomaly's txns appended on fresh
    processes and keys (the shape ``chip_smoke.py`` checks at 2048+
    txns), through the device backend."""
    h, jh = _list_append(11, n_txns=60)

    def fresh(hist):
        return [op.with_(process=op.process + 100,
                         value=tuple((f, k + 100, v) for f, k, v in op.value))
                for op in hist]

    h = h + fresh(TS.txn_anomaly_history(kind))
    jh = jh + fresh(JS.txn_anomaly_history(kind))
    got = check_txn(h, backend="device", device="cpu")
    assert got == jax_check_txn(jh, backend="device")
    assert got["valid?"] is False
    assert got["counterexample"]["class"] == \
        {"g1c": "G1c", "g2-item": "G2-item"}[kind]


def test_auto_takes_the_device_at_the_threshold(monkeypatch):
    h, _ = _list_append(3, n_txns=30)
    calls = []
    real = TC.cyclic_layers_device

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(TC, "cyclic_layers_device", spy)
    want = check_txn(h, backend="host")
    monkeypatch.setattr(TCHECK, "DEVICE_THRESHOLD", 4)
    assert check_txn(h, device="cpu") == want
    assert calls == [torch.device("cpu")]
    assert TCHECK.DEVICE_THRESHOLD == 4


def test_device_backends_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    h = TS.txn_anomaly_history("g1c")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_txn(h)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_txn(h, backend="device")
    assert check_txn(h, backend="host")["valid?"] is False
