"""The port's provisioner (``comdb2_tpu_torch.harness.provision``:
``NodeLayout``, ``SutNodeDB``, ``local_layout``) against the JAX
package's — the mirror of ``tests/test_provision.py``.

Command stream: both packages' ``SutNodeDB`` provision the same layout
over a ``RecordingRemote`` each; the commands, uploads and readiness
probes recorded per host must be equal, for every option that reaches
the command line. End to end: ``harness.core.run`` of the port
provisions, runs the bank workload over the port's ``BankTcpClient``
and tears down a real three-node cluster; the history goes through the
port's bank checker and the JAX package's, with equal results.
"""

import os
import socket

import pytest

from comdb2_tpu.checker.workloads import bank_checker as jbank_checker
from comdb2_tpu.control import remote as JREM
from comdb2_tpu.harness import provision as JPROV

from comdb2_tpu_torch.checker.workloads import bank_checker
from comdb2_tpu_torch.control import remote as TREM
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import db as TDB
from comdb2_tpu_torch.harness import fake as TFAKE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.harness import provision as TPROV
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P


def _responder(REM):
    def respond(host, cmd):
        if "/dev/tcp" in cmd:
            return REM.ExecResult(0, "PONG\n" if "printf \"P" in cmd
                                  else "I 0 primary 0 0 1 0\n", "")
        return REM.ExecResult(0, "", "")
    return respond


LAYOUTS = {
    "hosts": dict(nodes=["m1", "m2", "m3"], base_dir="/opt/sut", kw={}),
    "localhost": dict(nodes=["n1", "n2", "n3", "n4", "n5"],
                      base_dir="/tmp/comdb2tpu-sut", local=True, kw={}),
    "flags": dict(nodes=["a", "b"], base_dir="/srv/x",
                  kw=dict(flags=["-B", "-x"], timeout_ms=300,
                          elect_ms=700, lease_ms=200)),
    "not-persistent": dict(nodes=["a", "b", "c"], base_dir="/opt/s",
                           kw=dict(persistent=False)),
    "quoted": dict(nodes=["n 1", "n$2"], base_dir="/tmp/with space",
                   kw=dict(flags=["-d", "it's"])),
}


def _provision(REM, PROV, case):
    spec = LAYOUTS[case]
    rec = REM.RecordingRemote()
    rec.responder = _responder(REM)
    nodes = spec["nodes"]
    if spec.get("local"):
        layout = PROV.local_layout(nodes, range(19000, 19000 + len(nodes)))
    else:
        layout = {n: PROV.NodeLayout(n, 19000) for n in nodes}
    db = PROV.SutNodeDB(rec, "/bin/true", layout,
                        base_dir=spec["base_dir"], **spec["kw"])
    test = {"nodes": nodes}
    for n in nodes:
        db.setup(test, n)
    db.setup_primary(test, nodes[0])
    logs = [db.log_files(test, n) for n in nodes]
    for n in nodes:
        db.setup(test, n)               # again: installed once per host
        db.teardown(test, n)
    return rec.commands, rec.uploads, logs


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_command_stream_equals_the_references(case):
    got = _provision(TREM, TPROV, case)
    want = _provision(JREM, JPROV, case)
    assert got == want


def test_provision_ssh_command_shape():
    """The SSH-shaped command stream (recorded transport): install,
    config artifact, daemon start with pidfile, readiness probes — per
    host, nothing pre-arranged."""
    commands, uploads, _ = _provision(TREM, TPROV, "hosts")
    nodes = LAYOUTS["hosts"]["nodes"]
    assert {h for h, _ in commands} == set(nodes)
    assert [u[0] for u in uploads] == nodes
    joined = "\n".join(c for _, c in commands)
    assert "mkdir -p /opt/sut/m1" in joined
    assert "-n m1:19000,m2:19000,m3:19000" in joined
    assert "> /opt/sut/m2/config" in joined
    assert "echo $! > /opt/sut/m3/pid" in joined
    assert any("kill -9" in c for _, c in commands)


def test_local_layout_and_not_ready_error():
    """``local_layout`` and the readiness timeout's error, as in the
    JAX package."""
    got = TPROV.local_layout(["a", "b"], [1, 2])
    want = JPROV.local_layout(["a", "b"], [1, 2])
    assert {k: (v.host, v.port) for k, v in got.items()} == \
        {k: (v.host, v.port) for k, v in want.items()}
    errs = []
    for REM, PROV in ((TREM, TPROV), (JREM, JPROV)):
        db = PROV.SutNodeDB(REM.RecordingRemote(), "/bin/true",
                            {"a": PROV.NodeLayout("h", 5)})
        with pytest.raises(RuntimeError) as e:
            db._await_ready("h", 5, deadline_s=0.2)
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "sut_node on h:5 not ready"


def _listening(port):
    s = socket.socket()
    s.settimeout(0.5)
    try:
        return s.connect_ex(("127.0.0.1", port)) == 0
    finally:
        s.close()


@CP.needs_sut_node
def test_provisioned_cluster_end_to_end(tmp_path):
    """``core.run`` provisions a three-node cluster from a bare base dir
    (upload, config, daemon start, readiness, primary gate), runs the
    bank workload over it, snarfs the logs and tears the daemons down."""
    nodes = ["n1", "n2", "n3"]
    ports = CP.free_ports(3)
    base = str(tmp_path / "sut")
    db = TPROV.SutNodeDB(TREM.LocalRemote(), CP.SUT_NODE,
                         TPROV.local_layout(nodes, ports), base_dir=base,
                         timeout_ms=500, elect_ms=500, lease_ms=300)
    n = 4
    t = TFAKE.noop_test(device="cpu")
    t.update({
        "nodes": nodes, "concurrency": 4, "name": "provisioned-bank",
        "store-root": str(tmp_path / "store"),
        "db": db,
        "client": TT.BankTcpClient(ports, n=n, timeout_s=0.6),
        "model": {"n": n, "total": n * 10},
        "_bank_n": n,
        "generator": TG.clients(TG.time_limit(3.0, TG.stagger(
            0.01, TG.mix([TW.bank_read, TW.bank_diff_transfer])))),
        "checker": bank_checker,
    })
    try:
        result = TCORE.run(t)
        res = result["results"]
        want = jbank_checker.check(None, t["model"],
                                   P.to_jax(result["history"]))
        assert P.plain(res) == P.plain(want)
        assert res["valid?"] is True, res
        reads = [op for op in result["history"]
                 if op.type == "ok" and op.f == "read"]
        assert len(reads) >= 10, len(reads)
        for node in nodes:
            assert os.path.exists(f"{base}/{node}/config")
            assert os.path.getsize(f"{base}/{node}/sut.log") > 0
        for node, port in zip(nodes, ports):
            assert not os.path.exists(f"{base}/{node}/pid")
            assert not _listening(port), f"{node} still on {port}"
    finally:
        for node in nodes:
            db.teardown(t, node)


@CP.needs_sut_node
def test_provision_cycle_wipes_state(tmp_path):
    """``db.cycle`` (teardown + setup) gives a fresh cluster: state
    written before the cycle is gone after it."""
    nodes = ["a", "b", "c"]
    ports = CP.free_ports(3)
    db = TPROV.SutNodeDB(TREM.LocalRemote(), CP.SUT_NODE,
                         TPROV.local_layout(nodes, ports),
                         base_dir=str(tmp_path / "sut"))
    test = {"nodes": nodes}
    try:
        for node in nodes:
            db.setup(test, node)
        db.setup_primary(test, nodes[0])
        c = CP.connect(TT.SutConnection, ports[0])
        try:
            assert c.request("M 1 W 5 42").startswith(("OK", "V"))
            assert c.request("R 5") == "V 42"
        finally:
            c.close()
        for node in nodes:
            TDB.cycle(db, test, node)
        db.setup_primary(test, nodes[0])
        c = CP.connect(TT.SutConnection, ports[1])
        try:
            assert c.request("R 5") == "NIL"
        finally:
            c.close()
    finally:
        for node in nodes:
            db.teardown(test, node)
