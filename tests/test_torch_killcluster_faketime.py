"""The port's kill-cluster diff oracle and fake-time wrappers
(``comdb2_tpu_torch.harness.killcluster``, ``harness.faketime``) against
the JAX package's — the mirror of ``tests/test_killcluster_faketime.py``.

The oracles, the scripted transcripts over each package's ``MemDB``,
the diff verdicts, the ``faketime`` wrapper scripts and the commands
issued over a ``RecordingRemote`` must be equal, string for string.
``cluster_set_workload`` runs against scripted line servers
(``torch_cluster_parity.LineServer``): its transcript and the lines it
sends must be equal, the per-run nonce session aside (drawn from the
OS in both packages).
"""

import os
import re

import pytest

from comdb2_tpu import control as JCTL
from comdb2_tpu.control import remote as JREM
from comdb2_tpu.harness import faketime as JFT
from comdb2_tpu.harness import killcluster as JKC
from comdb2_tpu.workloads.sqlish import MemDB as JMemDB

from comdb2_tpu_torch import control
from comdb2_tpu_torch.control import remote as TREM
from comdb2_tpu_torch.control.remote import LocalRemote, RecordingRemote
from comdb2_tpu_torch.harness import faketime, killcluster
from comdb2_tpu_torch.workloads.sqlish import MemDB

import torch_cluster_parity as CP


def test_oracle_shape():
    lines = list(killcluster.oracle(3))
    assert lines == ["[set transaction serializable] rc 0",
                     "[begin] rc 0", "(a=0)", "(a=1)", "(a=2)",
                     "[commit] rc 0"]


@pytest.mark.parametrize("n", [0, 1, 3, 257])
def test_oracles_equal_the_references(n):
    assert list(killcluster.oracle(n)) == list(JKC.oracle(n))
    assert list(killcluster.cluster_oracle(n)) == \
        list(JKC.cluster_oracle(n))


def test_killcluster_clean_run_matches_oracle():
    db = MemDB()
    r = killcluster.run(
        {}, lambda: killcluster.scripted_workload(db.connect(), 500),
        killcluster.oracle(500))
    assert r["valid?"] is True, r["diff"]
    jdb = JMemDB()
    want = JKC.run(
        {}, lambda: JKC.scripted_workload(jdb.connect(), 500),
        JKC.oracle(500))
    assert r == want


def test_killcluster_disruption_with_retries_still_matches():
    """Chaos aborts force retries mid-transaction; the committed
    transcript still equals the oracle, in both packages."""
    out = []
    for KC, DB in ((killcluster, MemDB), (JKC, JMemDB)):
        db = DB(chaos_fail=0.3, seed=3)
        disrupted = []
        out.append(KC.run(
            {}, lambda: KC.scripted_workload(db.connect(), 300),
            KC.oracle(300), disrupt=lambda: disrupted.append(True),
            disrupt_after_s=0.0))
    assert out[0]["valid?"] is True, out[0]["diff"]
    assert out[0] == out[1]


def _lossy(db, lost):
    def workload():
        yield "[set transaction serializable] rc 0"
        yield "[begin] rc 0"
        conn = db.connect()
        with conn.transaction() as t:
            for i in range(100):
                if i not in lost:
                    t.insert("killcluster", {"a": i})
        for row in sorted(r["a"] for r in conn.select("killcluster")):
            yield f"(a={row})"
        yield "[commit] rc 0"
    return workload


@pytest.mark.parametrize("lost", [(50,), (0, 99), tuple(range(20))])
def test_killcluster_detects_lost_rows(lost):
    r = killcluster.run({}, _lossy(MemDB(), lost), killcluster.oracle(100))
    assert r["valid?"] is False
    assert r["diff"][0]["expected"] == f"(a={lost[0]})"
    assert r == JKC.run({}, _lossy(JMemDB(), lost), JKC.oracle(100))


def test_a_crashed_workload_is_unknown_in_both():
    def crashing():
        yield "[begin] rc 0"
        raise OSError("connection reset")

    got = killcluster.run({}, crashing, killcluster.oracle(2))
    want = JKC.run({}, crashing, JKC.oracle(2))
    assert got["valid?"] == "unknown"
    assert got == want


def _per_host(commands):
    out = {}
    for h, c in commands:
        out.setdefault(h, []).append(c)
    return out


def test_kill_restart_all_commands():
    rec = RecordingRemote()
    test = {"nodes": ["n1", "n2"], "remote": rec}
    killcluster.kill_restart_all(test, "mydb",
                                 restart_cmd="systemctl start mydb",
                                 stagger_s=0)
    cmds = [c for _, c in rec.commands]
    assert any("pkill -KILL -f mydb" in c for c in cmds)
    assert any("systemctl start mydb" in c for c in cmds)
    jrec = JREM.RecordingRemote()
    JKC.kill_restart_all({"nodes": ["n1", "n2"], "remote": jrec}, "mydb",
                         restart_cmd="systemctl start mydb", stagger_s=0)
    assert _per_host(rec.commands) == _per_host(jrec.commands)


class _Procs:
    """A stand-in for ``ClusterProcs`` that records the calls."""

    def __init__(self):
        self.calls = []

    def kill9_all(self):
        self.calls.append("kill9_all")

    def restart_all(self):
        self.calls.append("restart_all")


@pytest.mark.parametrize("rounds", [1, 3])
def test_cluster_kill_restart_sequence(rounds):
    got, want = _Procs(), _Procs()
    killcluster.cluster_kill_restart(got, rounds=rounds, pause_s=0,
                                     between_s=0)()
    JKC.cluster_kill_restart(want, rounds=rounds, pause_s=0,
                             between_s=0)()
    assert got.calls == want.calls == ["kill9_all", "restart_all"] * rounds


def _fake_cluster(i, acked):
    """Node ``i`` of a scripted three-node cluster: node 0 is primary,
    every add is acked once per value, ``S`` reads the acked set."""
    def respond(line):
        if line == "I":
            role = "primary" if i == 0 else "replica"
            return f"I {i} {role} 5 5 1 0"
        if line.startswith("M "):
            acked.add(int(line.split()[-1]))
            return "OK 3"
        if line == "S":
            return "V " + " ".join(str(v) for v in sorted(acked))
        return "ERR"
    return respond


def _set_workload(KC, n):
    acked = set()
    with CP.line_servers([_fake_cluster(i, acked)
                          for i in range(3)]) as servers:
        wl = KC.cluster_set_workload([s.port for s in servers], n,
                                     timeout_s=0.5)
        lines = list(wl())
        sent = [(i, re.sub(r"^M \d+ ", "M <nonce> ", line))
                for i, _, line in CP.recorded(servers)]
    return lines, sent


@pytest.mark.parametrize("n", [1, 6])
def test_cluster_set_workload_transcript_and_requests(n):
    got = _set_workload(killcluster, n)
    want = _set_workload(JKC, n)
    assert got == want
    assert got[0] == list(killcluster.cluster_oracle(n))


@pytest.mark.parametrize("args", [
    ("/usr/bin/myapp", -30, 1.5), ("/opt/db", 0, 1), ("x", 0.25, 0.5),
    ("/a b/c", 12.5, 3), ("cmd", -0.001, 1e-3), ("cmd", 86400, 100)])
def test_faketime_script_equals_the_references(args):
    assert faketime.script(*args) == JFT.script(*args)


def _wrap_commands(CTL, REM, FT, exists):
    rec = REM.RecordingRemote()
    rec.responder = lambda host, cmd: (
        REM.ExecResult(0 if exists else 1, "", "")
        if cmd.startswith("test -e") else None)
    with CTL.with_session(CTL.Session("n1", rec)):
        FT.wrap("/usr/bin/myapp", -2, 1.25)
        FT.unwrap("/usr/bin/myapp")
    return rec.commands


@pytest.mark.parametrize("exists", [False, True])
def test_faketime_wrap_commands_equal_the_references(exists):
    assert _wrap_commands(control, TREM, faketime, exists) == \
        _wrap_commands(JCTL, JREM, JFT, exists)


def test_faketime_script_and_wrap(tmp_path):
    s = faketime.script("/usr/bin/myapp", -30, 1.5)
    assert 'faketime -m -f "-30s x1.5" /usr/bin/myapp "$@"' in s

    target = tmp_path / "app"
    target.write_text("#!/bin/bash\necho real\n")
    target.chmod(0o755)
    sess = control.Session("localhost", LocalRemote(),
                           root=os.geteuid() == 0)
    with control.with_session(sess):
        faketime.wrap(str(target), 10, 2.0)
        assert (tmp_path / "app.no-faketime").exists()
        body = target.read_text()
        assert "faketime" in body and "app.no-faketime" in body
        faketime.wrap(str(target), 10, 2.0)
        assert "echo real" in (tmp_path / "app.no-faketime").read_text()
        faketime.unwrap(str(target))
        assert target.read_text().endswith("echo real\n")
