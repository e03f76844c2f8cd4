"""The port's test runner (``comdb2_tpu_torch.harness``: ``core``,
``fake``, ``client``, ``db``, ``cli``) against the JAX package's.

Runs that are deterministic under a seed (one worker: the stdlib
``random`` state is drawn from on that worker's thread only) must give
equal histories, apart from each op's ``time``, and equal results.
Runs with many workers interleave by thread timing, so there the port's
recorded history goes through both packages' checker compositions,
which must give equal results; and the JAX harness's recorded history
goes through the port's. Results compare with ``==`` after
``torch_harness_parity.plain`` (ops as plain tuples; the engine labels
dropped, which name the engine, not the verdict). The port's checkers
run at ``device="cpu"``. The repl helpers (``harness/repl.py``) reload
a saved run and re-check it through the port's checkers, as the JAX
package's do.
"""

import os
import random

import pytest

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.control import remote as JREM
from comdb2_tpu.harness import cli as JCLI
from comdb2_tpu.harness import client as JCL
from comdb2_tpu.harness import core as JCORE
from comdb2_tpu.harness import db as JDB
from comdb2_tpu.harness import fake as JF
from comdb2_tpu.harness import generator as JG
from comdb2_tpu.models import model as JM
from comdb2_tpu import control as JCTL
from comdb2_tpu import report as JR

from comdb2_tpu_torch import control as TCTL
from comdb2_tpu_torch import report as TR
from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.control import remote as TREM
from comdb2_tpu_torch.harness import cli as TCLI
from comdb2_tpu_torch.harness import client as TCL
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import db as TDB
from comdb2_tpu_torch.harness import fake as TF
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.models import model as TM

import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

TORCH = dict(C=TC, CORE=TCORE, F=TF, G=TG, M=TM, CL=TCL, DB=TDB,
             REM=TREM, CTL=TCTL, R=TR, CLI=TCLI, kw={"device": "cpu"})
JAX = dict(C=JC, CORE=JCORE, F=JF, G=JG, M=JM, CL=JCL, DB=JDB,
           REM=JREM, CTL=JCTL, R=JR, CLI=JCLI, kw={})


def _linearizable(pkg):
    return pkg["C"].Linearizable(**pkg["kw"])


def _atom_test(pkg, root, **kw):
    F = pkg["F"]
    state = F.Atom()
    t = F.noop_test(**pkg["kw"])
    t.update({"nodes": [], "concurrency": 4, "db": F.atom_db(state),
              "client": F.atom_client(state),
              "model": pkg["M"].cas_register(), "store-root": str(root),
              "name": "atom-test",
              "checker": pkg["C"].compose({
                  "linearizable": _linearizable(pkg),
                  "perf": pkg["R"].perf_checker(),
                  "timeline": pkg["R"].Timeline()})})
    t.update(kw)
    return t


def _run(pkg, seed, build):
    random.seed(seed)
    return pkg["CORE"].run(build(pkg))


def _fields(h):
    return [P.op_fields(op, time=False) for op in h]


def test_noop_run(tmp_path):
    out = []
    for pkg, root in ((TORCH, tmp_path / "t"), (JAX, tmp_path / "j")):
        t = pkg["F"].noop_test(**pkg["kw"])
        t.update({"nodes": [], "store-root": str(root)})
        r = pkg["CORE"].run(t)
        out.append((r["history"], P.plain(r["results"]), r["concurrency"]))
    assert out[0] == out[1] == ([], {"valid?": True, "backend": "trivial"}, 1)


@pytest.mark.parametrize("seed,n", [(0, 30), (1, 30), (2, 90), (5, 90)])
def test_one_worker_runs_equal(tmp_path, seed, n):
    """Concurrency 1 over the atom register with ``limit(n, cas_gen)``:
    the same ops in the same order, the same results (n = 90 passes the
    host threshold of 128 events, so both take their device engines)."""
    runs = [_run(pkg, seed, lambda pkg, root=root: _atom_test(
        pkg, root, concurrency=1,
        generator=pkg["G"].clients(pkg["G"].limit(n, pkg["G"].cas_gen))))
        for pkg, root in ((TORCH, tmp_path / "t"), (JAX, tmp_path / "j"))]
    assert _fields(runs[0]["history"]) == _fields(runs[1]["history"])
    assert len(runs[0]["history"]) == 2 * n
    assert P.plain(runs[0]["results"]) == P.plain(runs[1]["results"])
    assert runs[0]["results"]["valid?"] is True


def _lying_client(CL):
    class Lying(CL.Client):
        """Reads return a value no write wrote."""

        def invoke(self, test, op):
            if op["f"] == "read":
                return {**op, "type": "ok", "value": 42}
            return {**op, "type": "ok"}
    return Lying()


@pytest.mark.parametrize("lie", [False, True])
def test_ten_workers_history_checked_by_both(tmp_path, lie):
    """Concurrency 10: the port's recorded history through the port's
    and the JAX package's checker compositions gives equal results."""
    G = TG
    t = _atom_test(TORCH, tmp_path / "t", concurrency=10,
                   generator=G.clients(G.each(lambda: G.concat(G.seq(
                       [{"type": "invoke", "f": "write", "value": 1},
                        {"type": "invoke", "f": "read", "value": None}]),
                       G.limit(12, G.cas_gen)))))
    if lie:
        t["client"] = _lying_client(TCL)
    r = TCORE.run(t)
    h = r["history"]
    assert len({op.process for op in h}) == 10
    opts = {"dir": str(tmp_path / "again")}
    want = _atom_test(JAX, tmp_path / "j")["checker"].check(
        {}, JM.cas_register(), P.to_jax(h), opts)
    assert P.plain(r["results"]) == P.plain(want)
    assert r["results"]["valid?"] is (not lie)


def test_jax_harness_history_checked_by_the_port(tmp_path):
    G = JG
    t = _atom_test(JAX, tmp_path / "j", concurrency=8,
                   generator=G.clients(G.limit(100, G.cas_gen)))
    r = JCORE.run(t)
    got = _atom_test(TORCH, tmp_path / "t")["checker"].check(
        {}, TM.cas_register(), P.to_torch(r["history"]),
        {"dir": str(tmp_path / "again")})
    assert P.plain(got) == P.plain(r["results"])
    assert got["valid?"] is True


def _crashy(CL, every):
    class Crashy(CL.Client):
        def __init__(self):
            self.n = 0

        def invoke(self, test, op):
            self.n += 1
            if self.n % every == 0:
                raise RuntimeError("network exploded")
            if self.n % every == 1:
                return {**op, "type": "info"}
            return {**op, "type": "ok"}
    return Crashy()


@pytest.mark.parametrize("every", [2, 3])
def test_process_recycling_after_crash_and_info(tmp_path, every):
    """A crashed op completes as ``info`` with the reference's error
    text and, like an ``info`` completion, retires its process: the
    worker carries on as process + concurrency."""
    runs = []
    for pkg, root in ((TORCH, tmp_path / "t"), (JAX, tmp_path / "j")):
        G = pkg["G"]
        t = _atom_test(pkg, root, concurrency=1,
                       client=_crashy(pkg["CL"], every),
                       checker=pkg["C"].unbridled_optimism,
                       generator=G.clients(G.limit(7, {
                           "type": "invoke", "f": "read", "value": None})))
        runs.append(pkg["CORE"].run(t))
    assert _fields(runs[0]["history"]) == _fields(runs[1]["history"])
    procs = [op.process for op in runs[0]["history"]]
    assert procs[0] == 0 and max(procs) > 1
    infos = [op for op in runs[0]["history"] if op.type == "info"]
    assert any("indeterminate: network exploded" in
               op.extra.get("error", "") for op in infos)


def _nemesis_client(CL, events, crash):
    class Nem(CL.Client):
        def invoke(self, test, op):
            events.append(op["f"])
            if crash and op["f"] == "stop":
                raise RuntimeError("cable cut")
            return {**op, "value": f"did {op['f']}"}
    return Nem()


@pytest.mark.parametrize("crash", [False, True])
def test_nemesis_worker(tmp_path, crash):
    """The nemesis thread draws the nemesis's ops from the same
    generator; completions stay ``info``; a crash is recorded as the
    invocation with the reference's ``crashed:`` value."""
    runs = []
    for pkg, root in ((TORCH, tmp_path / "t"), (JAX, tmp_path / "j")):
        G = pkg["G"]
        events = []
        t = _atom_test(pkg, root, concurrency=1,
                       nemesis=_nemesis_client(pkg["CL"], events, crash),
                       generator=G.nemesis(
                           G.seq([{"type": "info", "f": "start"},
                                  {"type": "info", "f": "stop"}]),
                           G.limit(10, G.cas_gen)))
        random.seed(3)
        r = pkg["CORE"].run(t)
        nem = [op for op in r["history"] if op.process == "nemesis"]
        cli = [op for op in r["history"] if op.process != "nemesis"]
        runs.append((events, _fields(nem), _fields(cli),
                     P.plain(r["results"])))
    assert runs[0] == runs[1]
    assert runs[0][0] == ["start", "stop"]
    assert len(runs[0][1]) == 4
    if crash:
        assert runs[0][1][-1][3] == "crashed: cable cut"


def _cli_test_fn(pkg, root, seen):
    def test_fn(opts):
        seen.append(dict(opts))
        t = _atom_test(pkg, root, concurrency=opts["concurrency"],
                       name="cli-test",
                       generator=pkg["G"].clients(
                           pkg["G"].limit(10, pkg["G"].cas_gen)))
        t["store-root"] = opts["store-root"]
        return t
    return test_fn


def test_cli_runs_a_test(tmp_path):
    seen_t, seen_j = [], []
    argv = ["--concurrency", "2", "--test-count", "2", "-n", "a", "-n",
            "b", "--store-root"]
    rc_t = TCLI.single_test_cmd(
        _cli_test_fn(TORCH, tmp_path, seen_t),
        argv=argv + [str(tmp_path / "t"), "--device", "cpu"])
    rc_j = JCLI.single_test_cmd(_cli_test_fn(JAX, tmp_path, seen_j),
                                argv=argv + [str(tmp_path / "j")])
    assert rc_t == rc_j == 0
    assert len(seen_t) == len(seen_j) == 2
    for t_opts, j_opts in zip(seen_t, seen_j):
        assert t_opts.pop("device") == "cpu"
        assert {**t_opts, "store-root": None} == \
            {**j_opts, "store-root": None}


@pytest.mark.parametrize("verdicts,rc", [
    ([True, True], 0), (["unknown", True], 2), (["unknown", False], 1),
    ([False, "unknown"], 1), (["unknown", "unknown"], 2),
    ([None, True], 1)])
def test_cli_exit_codes(monkeypatch, verdicts, rc):
    """0 iff every run is valid, 2 on unknown, 1 on invalid; invalid
    dominates unknown (a missing verdict counts as invalid)."""
    codes = []
    for pkg, extra in ((TORCH, ["--device", "cpu"]), (JAX, [])):
        it = iter(verdicts)
        monkeypatch.setattr(pkg["CORE"], "run",
                            lambda test, it=it: {"results": {
                                "valid?": next(it)}})
        codes.append(pkg["CLI"].single_test_cmd(
            lambda opts: {}, argv=["--test-count", "2"] + extra))
    assert codes == [rc, rc]


def test_cli_default_device_raises_before_any_test_is_built():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    built = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCLI.single_test_cmd(lambda opts: built.append(opts) or {},
                             argv=[])
    assert built == []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.noop_test()


def _logged_db(pkg, ctl):
    DB = pkg["DB"]

    class LoggedDB(DB.DB, DB.LogFiles, DB.Primary):
        def setup(self, test, node):
            ctl.su("systemctl", "start", "mydb")

        def teardown(self, test, node):
            ctl.su("systemctl", "stop", "mydb")

        def setup_primary(self, test, node):
            # core.run calls this on its own thread, with no session
            with ctl.on(node, test["remote"]):
                ctl.exec_("mydb-init", "--primary", node)

        def log_files(self, test, node):
            return [f"/var/log/sut/{node}.log", "/var/log/sut/common.log"]
    return LoggedDB()


def test_node_lifecycle_and_snarf_logs_over_a_recording_remote(tmp_path):
    """Five nodes through ``RecordingRemote``: os and db set up and torn
    down on every node, the primary set up once, each node's logs
    downloaded into the test's store directory before teardown."""
    out = []
    for pkg, root in ((TORCH, tmp_path / "t"), (JAX, tmp_path / "j")):
        rec = pkg["REM"].RecordingRemote()
        t = _atom_test(pkg, root, concurrency=5,
                       nodes=["n1", "n2", "n3", "n4", "n5"], remote=rec,
                       name="snarf", db=_logged_db(pkg, pkg["CTL"]),
                       generator=pkg["G"].clients(
                           pkg["G"].limit(6, pkg["G"].cas_gen)))
        r = pkg["CORE"].run(t)
        per_host = {}
        for h, c in rec.commands:
            per_host.setdefault(h, []).append(c)
        downloads = sorted((h, rp, os.path.relpath(lp, str(root)))
                           for h, rp, lp in rec.downloads)
        out.append((per_host, downloads, r["results"]["valid?"]))
    assert out[0] == out[1]
    assert len(out[0][1]) == 10
    assert "systemctl stop mydb" in out[0][0]["n1"][-1]
    assert any("mydb-init --primary n1" in c for c in out[0][0]["n1"])


def test_on_nodes_parallel_and_errors():
    for CORE in (TCORE, JCORE):
        calls = []
        CORE._on_nodes({"nodes": ["a", "b", "c"]},
                       lambda test, node: calls.append(node))
        assert sorted(calls) == ["a", "b", "c"]
        with pytest.raises(ValueError):
            CORE._on_nodes({"nodes": ["a"]},
                           lambda test, node: (_ for _ in ()).throw(
                               ValueError(node)))
        CORE._on_nodes({"nodes": []}, lambda test, node: 1 / 0)


def test_history_and_op_conversion():
    for CORE in (TCORE, JCORE):
        h = CORE.History()
        a = CORE._op_from_dict({"type": "invoke", "f": "read",
                                "value": None, "x": 1}, 3, 10)
        h.conj(a)
        assert h.snapshot() == [a] and a.extra == {"x": 1}
        assert CORE._as_dict(a) == {"type": "invoke", "f": "read",
                                    "value": None, "process": 3, "x": 1}
    assert P.op_fields(TCORE._op_from_dict(
        {"type": "ok", "f": "w", "value": 2, "process": 9}, 3, 5)) == \
        P.op_fields(JCORE._op_from_dict(
            {"type": "ok", "f": "w", "value": 2, "process": 9}, 3, 5))


# --- the repl helpers (harness/repl.py) ----------------------------------------

class _Raising(TC.Checker):
    def check(self, test, model, history, opts=None):
        raise RuntimeError("checker broke")


def test_repl_last_test_and_recheck(tmp_path):
    """A run saved by the port's harness reloads through both packages'
    ``last_test`` to the same history, and ``recheck`` through the
    port's checkers (on CPU tensors) gives the JAX package's result, an
    error included."""
    from comdb2_tpu.harness import repl as JREPL
    from comdb2_tpu_torch.harness import repl

    random.seed(3)
    state = TF.Atom()
    t = TF.noop_test(device="cpu")
    store = str(tmp_path / "store")
    t.update({"nodes": [], "concurrency": 3, "name": "repl-test",
              "store-root": store, "db": TF.atom_db(state),
              "client": TF.atom_client(state), "model": TM.cas_register(),
              "generator": TG.clients(TG.limit(12, TG.cas_gen))})
    TCORE.run(t)
    loaded = repl.last_test("repl-test", store)
    jloaded = JREPL.last_test("repl-test", store)
    assert loaded is not None and jloaded is not None
    assert [P.op_fields(o) for o in loaded["history"]] == \
        [P.op_fields(o) for o in jloaded["history"]]
    assert repl.last_test("no-such-test", store) is None
    r = repl.recheck(loaded, TC.Linearizable(device="cpu"),
                     TM.cas_register())
    want = JREPL.recheck(jloaded, JC.linearizable, JM.cas_register())
    assert P.plain(r) == P.plain(want)
    assert r["valid?"] is True
    broken = repl.recheck(loaded, _Raising(), TM.cas_register())
    assert broken["valid?"] == "unknown"
    assert "checker broke" in broken["error"]
    assert repl.recheck({}, TC.Linearizable(device="cpu"),
                        TM.cas_register())["valid?"] is True

    out = tmp_path / "report.txt"
    with repl.to_file(str(out)):
        print("report body")
    assert out.read_text() == "report body\n"
