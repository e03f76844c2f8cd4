"""The port's control plane (``comdb2_tpu_torch.control``: sessions,
escaping, the transports, ``util``, ``net``) and the nemeses and
cluster helpers that drive it (``harness.nemesis``, ``harness.cluster``)
against the JAX package's.

The same calls go to both packages over a ``RecordingRemote`` each; the
command strings they record, the values they return and the grudges
they draw (the stdlib ``random`` state seeded before each) must be
equal. Commands issued from parallel per-node threads are compared as
sorted lists; each node's own commands keep their order. The time
nemesis (``harness.nemesis_time``) is held the same way, and its C
helpers are compiled here and their argv contract checked.
"""

import random
import time

import pytest

from comdb2_tpu import control as JCTL
from comdb2_tpu.control import net as JNET
from comdb2_tpu.control import remote as JREM
from comdb2_tpu.control import util as JUTIL
from comdb2_tpu.harness import cluster as JCLU
from comdb2_tpu.harness import nemesis as JN
from comdb2_tpu.harness import nemesis_time as JNT

from comdb2_tpu_torch import control as TCTL
from comdb2_tpu_torch.control import net as TNET
from comdb2_tpu_torch.control import remote as TREM
from comdb2_tpu_torch.control import util as TUTIL
from comdb2_tpu_torch.harness import cluster as TCLU
from comdb2_tpu_torch.harness import nemesis as TN
from comdb2_tpu_torch.harness import nemesis_time as TNT

NODES = ["n1", "n2", "n3", "n4", "n5"]


def _responder(REM):
    def respond(host, cmd):
        if cmd.startswith("getent hosts"):
            name = cmd.split()[-1]
            return REM.ExecResult(0, f"10.0.0.{name[-1]} {name}", "")
        if "mktemp" in cmd:
            return REM.ExecResult(0, "/tmp/tmp.X", "")
        if "qdisc del" in cmd:
            return REM.ExecResult(2, "", "No such file or directory")
        return None
    return respond


def _per_host(rec):
    out = {}
    for h, c in rec.commands:
        out.setdefault(h, []).append(c)
    return out


@pytest.mark.parametrize("args", [
    ("echo", "hi there"), ("ls", "-l"), ("echo", "a && b"),
    ("printf", "%s\n", "it's"), ("x", ""), ("cat", ["a", "b c"]),
    ("touch", "/tmp/with space/f"), ("echo", 3, 4.5, None),
    ("rm", "-rf", "$HOME"), ("grep", "-e", "a|b", "*.log")])
def test_build_cmd_and_escape(args):
    assert TCTL.build_cmd(*args) == JCTL.build_cmd(*args)
    assert [TCTL.escape(a) for a in args] == [JCTL.escape(a) for a in args]
    lit_args = [TCTL.lit(a) if isinstance(a, str) else a for a in args]
    jlit_args = [JCTL.lit(a) if isinstance(a, str) else a for a in args]
    assert TCTL.build_cmd(*lit_args) == JCTL.build_cmd(*jlit_args)


@pytest.mark.parametrize("sudo,cwd,root", [
    (None, None, False), ("root", None, False), ("root", "/tmp", False),
    ("root", "/var/x y", True), ("comdb2", "/srv/db", True),
    (None, "/srv", False)])
def test_session_wrap(sudo, cwd, root):
    t = TCTL.Session("h", TREM.RecordingRemote(), sudo=sudo, cwd=cwd,
                     root=root)
    j = JCTL.Session("h", JREM.RecordingRemote(), sudo=sudo, cwd=cwd,
                     root=root)
    for cmd in ("ls -l", "echo 'q'", "a && b"):
        assert t.wrap(cmd) == j.wrap(cmd)


def _exec_surface(CTL, REM, UTIL):
    rec = REM.RecordingRemote(responder=_responder(REM))
    out = []
    with CTL.on("h", rec):
        out.append(CTL.exec_("echo", "hello"))
        out.append(CTL.su("whoami"))
        out.append(UTIL.exists("/etc/hosts"))
        out.append(UTIL.tmp_dir())
        out.append(UTIL.wget("http://example.invalid/a/b.tgz"))
        out.append(UTIL.wget("http://example.invalid/c", dest="/tmp/c"))
        out.append(UTIL.install_tarball("http://example.invalid/t.tar",
                                        "/srv/t"))
        UTIL.grepkill("myproc")
        UTIL.grepkill("other", signal="TERM")
        UTIL.start_daemon("/usr/bin/db", "--flag", "v w",
                          logfile="/var/log/db.log",
                          pidfile="/var/run/db.pid", chdir="/srv")
        UTIL.stop_daemon("/var/run/db.pid")
        CTL.upload("/l/a", "/r/a")
        CTL.download("/r/b", "/l/b")
    return out, rec.commands, rec.uploads, rec.downloads


def test_exec_su_and_util_commands():
    assert _exec_surface(TCTL, TREM, TUTIL) == \
        _exec_surface(JCTL, JREM, JUTIL)


def test_exec_errors_equal():
    for CTL, REM in ((TCTL, TREM), (JCTL, JREM)):
        with pytest.raises(RuntimeError, match="no control session"):
            CTL.exec_("echo", "x")
    msgs = []
    for CTL, REM in ((TCTL, TREM), (JCTL, JREM)):
        rec = REM.RecordingRemote(
            responder=lambda h, c, REM=REM: REM.ExecResult(3, "o", "e"))
        with CTL.on("h", rec):
            with pytest.raises(REM.RemoteError) as e:
                CTL.exec_("false")
            assert CTL.exec_("false", check=False) == "o"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_local_remote_runs_here():
    outs = []
    for CTL, REM in ((TCTL, TREM), (JCTL, JREM)):
        s = CTL.Session("localhost", REM.LocalRemote())
        with CTL.with_session(s):
            outs.append((CTL.exec_("echo", "hello world"),
                         CTL.exec_("false", check=False)))
    assert outs[0] == outs[1] == ("hello world", "")


@pytest.mark.parametrize("opts", [
    {}, {"username": "root", "port": 2222},
    {"private-key-path": "/k/id", "strict-host-key-checking": True},
    {"username": "u", "port": 22, "private-key-path": "/k"}])
def test_ssh_argv(opts):
    t, j = TREM.SSHRemote(opts), JREM.SSHRemote(opts)
    assert t._base("h1") == j._base("h1")
    assert t._scp_base() == j._scp_base()
    assert t._dest("h1", "/dir with space/f") == \
        j._dest("h1", "/dir with space/f")


def _net_commands(REM, NET, method, *args):
    rec = REM.RecordingRemote(responder=_responder(REM))
    test = {"nodes": NODES, "remote": rec}
    getattr(NET.IptablesNet(), method)(test, *args)
    return _per_host(rec)


@pytest.mark.parametrize("method,args", [
    ("drop", ("n1", "n2")), ("drop", ("10.1.2.3", "n4")), ("heal", ()),
    ("slow", ()), ("slow", (80, 5, "pareto")), ("flaky", ()),
    ("fast", ())])
def test_iptables_net_commands(method, args):
    assert _net_commands(TREM, TNET, method, *args) == \
        _net_commands(JREM, JNET, method, *args)


def test_noop_net_records_nothing():
    for REM, NET in ((TREM, TNET), (JREM, JNET)):
        rec = REM.RecordingRemote()
        test = {"nodes": NODES, "remote": rec}
        n = NET.noop
        n.drop(test, "a", "b")
        n.heal(test)
        n.slow(test)
        n.flaky(test)
        n.fast(test)
        assert rec.commands == []


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_grudges(seed):
    out = []
    for N in (TN, JN):
        random.seed(seed)
        out.append((N.bisect(NODES), N.split_one(NODES),
                    N.split_one(NODES, loner="n3"),
                    N.complete_grudge([["n1", "n2"], ["n3", "n4", "n5"]]),
                    N.bridge(NODES), N.majorities_ring(NODES),
                    N.majority(7),
                    N.sorted_grudge_str(N.majorities_ring(NODES))))
    assert out[0] == out[1]


PARTITIONERS = ("partition_halves", "partition_random_halves",
                "partition_random_node", "partition_majorities_ring")


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("make", PARTITIONERS)
def test_partitioner_commands(make, seed):
    """Start, stop, start, teardown of each partitioner under one seed:
    the op values and each node's command stream are equal."""
    out = []
    for REM, NET, N in ((TREM, TNET, TN), (JREM, JNET, JN)):
        random.seed(seed)
        rec = REM.RecordingRemote(responder=_responder(REM))
        test = {"nodes": NODES, "remote": rec, "net": NET.IptablesNet()}
        nem = getattr(N, make)().setup(test, None)
        vals = [nem.invoke(test, {"type": "info", "f": f, "value": None})
                for f in ("start", "stop", "start")]
        nem.teardown(test)
        with pytest.raises(ValueError):
            nem.invoke(test, {"type": "info", "f": "bogus"})
        out.append((vals, _per_host(rec)))
    assert out[0] == out[1]
    assert "Cut off" in out[0][0][0]["value"]


def test_compose_routes_and_renames():
    out = []
    for N in (TN, JN):
        class Recorder(N.client_ns.Client):
            def __init__(self):
                self.fs = []

            def invoke(self, test, op):
                self.fs.append(op["f"])
                return dict(op)

        a, b = Recorder(), Recorder()
        nem = N.compose([(frozenset({"start", "stop"}), a),
                         ({"kill-start": "start"}, b)]).setup({}, None)
        r1 = nem.invoke({}, {"type": "info", "f": "start"})
        r2 = nem.invoke({}, {"type": "info", "f": "kill-start"})
        with pytest.raises(ValueError):
            nem.invoke({}, {"type": "info", "f": "nope"})
        nem.teardown({})
        out.append((a.fs, b.fs, r1, r2))
    assert out[0] == out[1]


def test_hammer_time_and_clock_scrambler(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    out = []
    for REM, N in ((TREM, TN), (JREM, JN)):
        random.seed(11)
        rec = REM.RecordingRemote()
        test = {"nodes": NODES, "remote": rec}
        ham = N.hammer_time("comdb2")
        vals = [ham.invoke(test, {"type": "info", "f": f, "value": None})
                for f in ("start", "start", "stop", "stop")]
        clk = N.clock_scrambler(60)
        vals.append(clk.invoke(test, {"type": "info", "f": "scramble",
                                      "value": None}))
        clk.teardown(test)
        out.append((vals, _per_host(rec)))
    assert out[0] == out[1]


def test_on_nodes_results_and_errors():
    for CTL, REM in ((TCTL, TREM), (JCTL, JREM)):
        rec = REM.RecordingRemote()
        test = {"nodes": NODES, "remote": rec}

        def f(test_, node, CTL=CTL):
            CTL.exec_("hostname")
            return CTL.current_session().host.upper()

        assert CTL.on_nodes(test, f) == {n: n.upper() for n in NODES}
        assert CTL.on_many(test, ["n2"], f) == {"n2": "N2"}
        with pytest.raises(KeyError):
            CTL.on_nodes(test, lambda t, n: {}[n])
        assert sorted(rec.commands) == sorted(
            [(n, "hostname") for n in NODES] + [("n2", "hostname")])
        assert CTL.make_remote(test) is rec


def test_cluster_heal_await_and_loop():
    out = []
    for REM, CLU in ((TREM, TCLU), (JREM, JCLU)):
        rec = REM.RecordingRemote()
        test = {"nodes": NODES[:2], "remote": rec}
        CLU.heal_all(test, processes=["comdb2", "pmux"])
        probes = iter([False, False, True])
        CLU.await_fn(lambda: next(probes), timeout=5, interval=0.001)
        with pytest.raises(TimeoutError, match="coherency"):
            CLU.await_coherent(test, lambda t: False, timeout=0.01,
                               interval=0.001)
        runs = []

        def run_fn(t, runs=runs):
            runs.append(t)
            return {"results": {"valid?": len(runs) < 3}}
        n = CLU.test_loop(lambda: {"n": len(runs)}, run_fn,
                          pre=lambda t: None, max_runs=10)
        out.append((_per_host(rec), n, len(runs)))
    assert out[0] == out[1]
    assert out[0][1:] == (2, 3)


# --- precision clock faults (harness/nemesis_time.py) -------------------------

def _time_commands(CTL, REM, NT, root):
    rec = REM.RecordingRemote()
    with CTL.with_session(CTL.Session("n1", rec, root=root)):
        NT.install()
        NT.install(install_dir="/srv/t t")
        NT.bump_time(1500.7)
        NT.bump_time(-250)
        NT.strobe_time(200, 10, 1.5, install_dir="/srv/t t")
        NT.reset_time()
    # the helpers' sources go up from temporary files: compare where
    # they land, not the local names
    return rec.commands, [(h, dst) for h, _src, dst in rec.uploads]


@pytest.mark.parametrize("root", [False, True])
def test_nemesis_time_commands_equal_the_references(root):
    assert TNT.BUMP_TIME_C == JNT.BUMP_TIME_C
    assert TNT.STROBE_TIME_C == JNT.STROBE_TIME_C
    assert TNT.INSTALL_DIR == JNT.INSTALL_DIR
    got = _time_commands(TCTL, TREM, TNT, root)
    assert got == _time_commands(JCTL, JREM, JNT, root)
    assert any("bump-time 1500" in c for _, c in got[0])


def test_nemesis_time_compiles_real_helpers(tmp_path):
    """The port installs the bump / strobe C helpers locally; their argv
    contract holds (the clock itself is not set)."""
    import os
    import shutil
    import subprocess

    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    s = TCTL.Session("localhost", TREM.LocalRemote(),
                     root=os.geteuid() == 0)
    with TCTL.with_session(s):
        TNT.install(install_dir=str(tmp_path))
    for name in ("bump-time", "strobe-time"):
        binary = tmp_path / name
        assert binary.exists()
        p = subprocess.run([str(binary)], capture_output=True, text=True,
                           timeout=30)
        assert p.returncode == 2
        assert "usage" in p.stderr
