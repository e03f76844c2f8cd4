"""Crash-restart durability through the port
(``comdb2_tpu_torch.workloads.tcp``: ``spawn_cluster`` with state dirs,
``ClusterProcs.kill9`` / ``restart`` / ``kill9_all`` / ``restart_all``;
``harness.killcluster``: ``run``, ``cluster_set_workload``,
``cluster_oracle``, ``cluster_kill_restart``) — the mirror of
``tests/test_crash_restart.py``.

The same runs as the reference, driven by the port: a restarted node
replays its fsync'd log, a restarted replica is backfilled, the durable
cluster loses nothing across whole-cluster kill -9 rounds (the
transcript equals the oracle), and the ``-x`` no-fsync control loses
acked adds: the transcript diff catches it and both packages' set
checkers name the lost values with equal results.
"""

import pytest

from comdb2_tpu.checker import checkers as JC

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.harness import killcluster as KC
from comdb2_tpu_torch.ops.op import Op
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P


def _req(port, line, timeout=2.0):
    conn = TT.SutConnection("127.0.0.1", port, timeout_s=timeout)
    try:
        conn.connect()
        return conn.request(line)
    finally:
        conn.close()


def _await_primary(ctl, timeout_s=8.0):
    """Dir-backed nodes boot as replicas: wait for the first
    election."""
    pri = CP.wait_until(ctl.primary, timeout_s, step_s=0.1)
    assert pri is not None, f"no primary elected: {ctl.info()}"
    return pri


def _dirs(tmp_path, n):
    out = []
    for i in range(n):
        d = tmp_path / f"node{i}"
        d.mkdir(parents=True, exist_ok=True)
        out.append(str(d))
    return out


def _cluster(**kw):
    return CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=500,
                      elect_ms=500, lease_ms=300, **kw)


@CP.needs_sut_node
def test_node_recovers_state_from_log(tmp_path):
    """Register state, the replay-nonce table and the term survive a
    whole-cluster kill -9 and restart."""
    with _cluster(dirs=_dirs(tmp_path, 3)) as (ports, procs):
        assert isinstance(procs, TT.ClusterProcs)
        ctl = TT.ClusterControl(ports)
        pri = _await_primary(ctl)
        assert _req(ports[pri], "M 41 W 1 7").startswith("OK")
        r_c = _req(ports[pri], "M 42 C 1 7 8")
        assert r_c.startswith("OK")
        procs.kill9_all()
        procs.restart_all()
        pri = _await_primary(ctl)
        assert _req(ports[pri], "R 1") == "V 8"
        assert _req(ports[pri], "M 42 C 1 7 8") == r_c
        assert all(n.get("term", 0) >= 1 for n in ctl.info())


@CP.needs_sut_node
@pytest.mark.parametrize("use_dirs", [True, False])
def test_restarted_replica_is_backfilled(tmp_path, use_dirs):
    """A replica killed and restarted acks its true position and the
    leader backfills it; without a state dir the whole log is
    re-shipped."""
    dirs = _dirs(tmp_path, 3) if use_dirs else None
    with _cluster(dirs=dirs) as (ports, procs):
        ctl = TT.ClusterControl(ports)
        pri = _await_primary(ctl) if use_dirs else 0
        kill_me = next(i for i in range(3) if i != pri)
        for i in range(5):
            assert _req(ports[pri], f"W 1 {i}").startswith("OK")
        procs.kill9(kill_me)
        for i in range(5, 10):
            assert _req(ports[pri], f"W 1 {i}").startswith("OK")
        procs.restart(kill_me)
        assert ctl.await_replicated(timeout_s=10.0), \
            (f"dirs={use_dirs}: restarted replica never caught up",
             ctl.info())


@CP.needs_sut_node
def test_killcluster_durable_cluster_loses_nothing(tmp_path):
    """Exactly-once adds while every node is kill -9'd and restarted
    twice: the transcript equals the oracle."""
    n_values = 24
    with _cluster(dirs=_dirs(tmp_path, 3)) as (ports, procs):
        result = KC.run(
            {}, KC.cluster_set_workload(ports, n_values, pace_s=0.15),
            KC.cluster_oracle(n_values),
            disrupt=KC.cluster_kill_restart(procs, rounds=2),
            disrupt_after_s=0.8)
    assert result["valid?"] is True, result


@CP.needs_sut_node
def test_killcluster_no_fsync_control_detected(tmp_path):
    """``-x``: the kill -9 loses acked adds; the transcript diff catches
    it, and the acked-adds history is INVALID with the lost values named
    through both packages' set checkers."""
    n_values = 24
    with _cluster(dirs=_dirs(tmp_path, 3),
                  flags=["-x"]) as (ports, procs):
        result = KC.run(
            {}, KC.cluster_set_workload(ports, n_values, pace_s=0.15),
            KC.cluster_oracle(n_values),
            disrupt=KC.cluster_kill_restart(procs, rounds=2),
            disrupt_after_s=0.8)
    assert result["valid?"] is False, \
        ("no-fsync cluster lost nothing across kill -9?!", result)

    with _cluster(dirs=_dirs(tmp_path / "chk", 3),
                  flags=["-x"]) as (ports, procs):
        pri = _await_primary(TT.ClusterControl(ports))
        acked = [i for i in range(12)
                 if _req(ports[pri], f"M {100 + i} A {i}").startswith("OK")]
        assert len(acked) == 12
        procs.kill9_all()
        procs.restart_all()
        ctl = TT.ClusterControl(ports)

        def final_read():
            pri = ctl.primary()
            if pri is None:
                return None
            try:
                r = _req(ports[pri], "S")
            except (TimeoutError, OSError):
                return None
            return [int(x) for x in r[1:].split()] \
                if r.startswith("V") else None
        final = CP.wait_until(final_read, 8.0, step_s=0.1)
    assert final is not None
    history, t = [], 0
    for i in acked:
        history += [Op(process=0, type="invoke", f="add", value=i, time=t),
                    Op(process=0, type="ok", f="add", value=i, time=t + 1)]
        t += 2
    history += [Op(process=1, type="invoke", f="read", value=None, time=t),
                Op(process=1, type="ok", f="read", value=set(final),
                   time=t + 1)]
    res = TC.SetChecker().check(None, None, history)
    assert P.plain(res) == P.plain(
        JC.SetChecker().check(None, None, P.to_jax(history)))
    assert res["valid?"] is False, res
    assert res["lost"], "the checker must name the lost elements"


@CP.needs_sut_node
def test_cluster_procs_restart_keeps_argv(tmp_path):
    """``ClusterProcs`` keeps each node's argv, so a restart runs the
    node the spawn started."""
    ports = CP.free_ports(3)
    kw = dict(durable=False, timeout_ms=400, elect_ms=600, lease_ms=250,
              dirs=_dirs(tmp_path, 3), flags=["-D"])
    procs = TT.spawn_cluster(CP.SUT_NODE, ports, **kw)
    try:
        pid0 = procs[0].pid
        procs.kill9(0)
        procs.restart(0)
        assert procs[0].pid != pid0 and procs[0].poll() is None
        want = [[CP.SUT_NODE, "-i", str(i), "-n",
                 ",".join(map(str, ports)), "-t", "400", "-e", "600",
                 "-l", "250", "-d", kw["dirs"][i], "-N", "-D"]
                for i in range(3)]
        assert procs.argv_per_node == want
    finally:
        procs.kill9_all()
    assert all(p.poll() is not None for p in procs)
