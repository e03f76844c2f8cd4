"""The port's perf graphs, timeline and graph checkers
(``comdb2_tpu_torch.report``: ``perf``, ``timeline``, ``LatencyGraph``,
``RateGraph``, ``Timeline``, ``perf_checker``) and the store round trip
of a harness run, against the JAX package's.

The same test map and history go to both packages: every number they
compute is equal and every file they write is byte-equal (no
tolerance). A run the JAX harness saved loads in the port and re-checks
to the results the JAX package saved; the port's ``save_1`` /
``save_2`` write the JAX package's bytes for the same test map and
history.
"""

import os
import random

import pytest

from comdb2_tpu import report as JR
from comdb2_tpu.harness import core as JCORE
from comdb2_tpu.harness import fake as JF
from comdb2_tpu.harness import generator as JG
from comdb2_tpu.harness import store as JS
from comdb2_tpu.models import model as JM
from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.ops import op as JO
from comdb2_tpu.report import perf as JP
from comdb2_tpu.report import timeline as JT

from comdb2_tpu_torch import report as TR
from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.harness import store as TS
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.report import perf as TP
from comdb2_tpu_torch.report import timeline as TT

import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

SEC = 1_000_000_000
TEST = {"name": "report-test", "start-time": "20261017T000000"}


def _history(O, seed, n=120, procs=6, nemesis=True):
    """A timed history over ``procs`` processes: overlapping calls that
    complete ok, fail or info (an info retires its process), reads and
    writes, and nemesis start / stop windows; times in ns over ~45 s so
    the 30 s quantile windows and the 10 s rate buckets both split."""
    rng = random.Random(seed)
    h, t, open_ = [], 0, {}
    nxt = procs
    live = list(range(procs))
    for i in range(n):
        t += rng.randrange(SEC // 10, SEC // 2)
        p = rng.choice(live)
        if p in open_:
            f, v = open_.pop(p)
            typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
            out = rng.randrange(5) if f == "read" else v
            h.append(O.Op(p, typ, f, out, time=t))
            if typ == "info":
                live[live.index(p)] = nxt
                nxt += 1
        else:
            f = rng.choice(["read", "write"])
            v = None if f == "read" else rng.randrange(5)
            open_[p] = (f, v)
            h.append(O.Op(p, "invoke", f, v, time=t))
        if nemesis and i % 37 == 20:
            h.append(O.Op("nemesis", "info", "start" if i % 74 == 20
                          else "stop", None, time=t + 1))
    return h


HISTORIES = [(0, {}), (1, {"procs": 3}), (2, {"nemesis": False}),
             (3, {"n": 2}), (4, {"n": 0})]


def _both(seed, kw):
    return _history(TO, seed, **kw), _history(JO, seed, **kw)


@pytest.mark.parametrize("seed,kw", HISTORIES)
def test_perf_numbers(seed, kw):
    h, jh = _both(seed, kw)
    assert [(P.op_fields(a), P.op_fields(b))
            for a, b in TP.history_latencies(h)] == \
        [(P.op_fields(a), P.op_fields(b))
         for a, b in JP.history_latencies(jh)]
    assert TP.nemesis_intervals(h) == JP.nemesis_intervals(jh)
    assert TP.nemesis_intervals(h, final_time=99.0) == \
        JP.nemesis_intervals(jh, final_time=99.0)
    assert TP._latency_points(h) == JP._latency_points(jh)
    lat = [l for by_t in TP._latency_points(h).values()
           for ps in by_t.values() for _, l in ps]
    qs = (0.5, 0.95, 0.99, 1)
    assert TP.quantiles(qs, lat) == JP.quantiles(qs, lat)
    pts = [p for by_t in TP._latency_points(h).values()
           for ps in by_t.values() for p in ps]
    assert TP.latencies_to_quantiles(30, qs, pts) == \
        JP.latencies_to_quantiles(30, qs, pts)
    assert [TP.bucket_time(10, x) for x in (0, 4.9, 10, 33.3)] == \
        [JP.bucket_time(10, x) for x in (0, 4.9, 10, 33.3)]


@pytest.mark.parametrize("seed,kw", HISTORIES)
@pytest.mark.parametrize("graph", ["point_graph", "quantiles_graph",
                                   "rate_graph"])
def test_perf_graphs_byte_equal(tmp_path, graph, seed, kw):
    h, jh = _both(seed, kw)
    got = getattr(TP, graph)(TEST, h, str(tmp_path / "t" / "g.svg"))
    want = getattr(JP, graph)(TEST, jh, str(tmp_path / "j" / "g.svg"))
    assert got == want
    assert (tmp_path / "t" / "g.svg").read_bytes() == \
        (tmp_path / "j" / "g.svg").read_bytes()


@pytest.mark.parametrize("seed,kw", HISTORIES)
def test_timeline_byte_equal(tmp_path, seed, kw):
    h, jh = _both(seed, kw)
    assert [(P.op_fields(a), b and P.op_fields(b))
            for a, b in TT.pairs(h)] == \
        [(P.op_fields(a), b and P.op_fields(b)) for a, b in JT.pairs(jh)]
    assert TT.process_index(h) == JT.process_index(jh)
    got = TT.html(TEST, h, str(tmp_path / "t.html"))
    assert got == JT.html(TEST, jh, str(tmp_path / "j.html"))
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("where", ["store", "dir", "subdirectory"])
def test_graph_checkers_write_the_same_files(tmp_path, where):
    """``perf_checker``, ``latency_graph``, ``rate_graph`` and
    ``Timeline`` in a composition: the same results and the same files,
    in the test's store directory, an explicit ``dir`` or a
    ``subdirectory`` of it."""
    h, jh = _both(0, {})
    out = []
    for R, C, hist, root in ((TR, TC, h, tmp_path / "t"),
                             (JR, JC, jh, tmp_path / "j")):
        test = dict(TEST, **{"store-root": str(root)})
        opts = None
        if where != "store":
            test["dir"] = str(root)
        if where == "subdirectory":
            opts = {"subdirectory": "perf"}
        checker = C.compose({"perf": R.perf_checker(),
                             "latency": R.latency_graph(),
                             "rate": R.rate_graph(),
                             "timeline": R.Timeline()})
        out.append((checker.check(test, None, hist, opts), _tree(root)))
    assert out[0] == out[1]
    assert len(out[0][1]) == 4


def test_graph_checkers_without_a_location_write_nothing(tmp_path):
    h, jh = _both(1, {})
    for R, hist in ((TR, h), (JR, jh)):
        for c in (R.LatencyGraph(), R.RateGraph(), R.Timeline()):
            assert c.check({}, None, hist) == {"valid?": True}


def _jax_run(root, seed):
    random.seed(seed)
    state = JF.Atom()
    t = JF.noop_test()
    t.update({"nodes": [], "concurrency": 3, "db": JF.atom_db(state),
              "client": JF.atom_client(state),
              "model": JM.cas_register(), "store-root": str(root),
              "name": "round-trip",
              "generator": JG.clients(JG.limit(40, JG.cas_gen)),
              "checker": JC.compose({"linearizable": JC.Linearizable(),
                                     "perf": JR.perf_checker(),
                                     "timeline": JR.Timeline()})})
    return JCORE.run(t)


def test_jax_saved_run_loads_and_rechecks_in_the_port(tmp_path):
    r = _jax_run(tmp_path / "store", 4)
    root = str(tmp_path / "store")
    got = TS.load("round-trip", r["start-time"], store_root=root)
    want = JS.load("round-trip", r["start-time"], store_root=root)
    assert [P.op_fields(o) for o in got["history"]] == \
        [P.op_fields(o) for o in want["history"]] == \
        [P.op_fields(o) for o in r["history"]]
    assert got["results"] == want["results"]
    assert {k: v for k, v in got.items() if k != "history"} == \
        {k: v for k, v in want.items() if k != "history"}
    assert TS.tests("round-trip", root) == JS.tests("round-trip", root)
    assert TS.latest("round-trip", root)["start-time"] == r["start-time"]
    recheck = TC.compose({
        "linearizable": TC.Linearizable(device="cpu"),
        "perf": TR.perf_checker(), "timeline": TR.Timeline()}).check(
            {"dir": str(tmp_path / "again")}, TM.cas_register(),
            got["history"])
    assert P.plain(recheck) == P.plain(r["results"])


def test_save_writes_the_jax_packages_bytes(tmp_path, monkeypatch):
    """The same test map and history through each package's ``save_1``
    and ``save_2``: ``test.edn``, ``history.edn`` and ``results.edn``
    byte-equal, and the ``latest`` links alike (each package under its
    own directory, with the same relative store root)."""
    r = _jax_run(tmp_path / "run", 6)
    trees = []
    for S, hist, root in ((TS, P.to_torch(r["history"]), tmp_path / "t"),
                          (JS, r["history"], tmp_path / "j")):
        os.makedirs(root)
        monkeypatch.chdir(root)
        results = {"valid?": False, "perf": {"valid?": True},
                   "linearizable": {"valid?": False, "op": hist[3],
                                    "op-index": 3, "configs": ["x"]},
                   "tags": {"a", "b"}, "frac": 0.25}
        test = {"name": "saved", "start-time": "20261017T120000",
                "store-root": "store", "concurrency": 3,
                "nodes": ["n1", "n2"], "time-limit": 1.5,
                "ssh": {"username": "root", "port": 22},
                "client": object(), "checker": object(), "_clock": 1,
                "history": hist, "results": results}
        S.save_1(test)
        S.save_2(test)
        trees.append((_tree("store"), sorted(os.listdir("store")),
                      os.readlink(os.path.join("store", "saved",
                                               "latest"))))
    assert trees[0] == trees[1]
    assert set(trees[0][0]) == {os.path.join("saved", "20261017T120000",
                                             f) for f in
                                ("test.edn", "history.edn",
                                 "results.edn")}
