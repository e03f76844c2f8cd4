"""The port's verifier daemon end to end on CPU, against the JAX
package's answers.

One daemon subprocess (``python -m comdb2_tpu_torch.service --backend
cpu``) serves the module; every wait has a timeout and the fixture reaps
the child. Covered: the newline-JSON wire protocol (ping, status,
metrics, check, framing across sends, bad lines, unknown ops) and a
client that disconnects mid-request; ``filetest --service`` exit codes
on ``tests/fixtures/`` against the JAX package's ``filetest`` (0 / 1)
and against an unreachable daemon (3, in both packages); the
consistent-hash ``HashRing`` (the JAX package's owners, about 1/N of the
keys remapped when a node joins); ``RoutedClient`` over a fake pmux;
the supervisor spawning a daemon and reaping it on retire; and a
``--backend cuda`` daemon on a host without a card exiting non-zero
before any ready line.
"""

import json
import os
import random
import select
import socket
import subprocess
import sys
import time

import pytest
import torch

from comdb2_tpu import filetest as jax_filetest
from comdb2_tpu.ops.history import history_to_edn
from comdb2_tpu.ops.synth import mutate, register_history
from comdb2_tpu.service import client as JCL

from comdb2_tpu_torch import filetest as torch_filetest
from comdb2_tpu_torch.service import client as TCL
from comdb2_tpu_torch.service import supervisor as TSUP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READY_TIMEOUT_S = 120.0


def _spawn(*args, env=None):
    """Start a daemon; returns ``(proc, ready)`` (``ready`` None when it
    exited first). The caller reaps ``proc``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "comdb2_tpu_torch.service", "--port", "0",
         *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    ready, _, _ = select.select([proc.stdout], [], [], READY_TIMEOUT_S)
    if not ready:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError("daemon printed no ready line in time")
    line = proc.stdout.readline()
    return proc, (json.loads(line) if line.strip() else None)


def _reap(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    for f in (proc.stdout, proc.stderr):
        if f is not None:
            f.close()


@pytest.fixture(scope="module")
def daemon():
    proc, ready = _spawn("--backend", "cpu", "--batch-cap", "8")
    assert ready is not None and ready["ready"] is True, proc.stderr.read()
    assert ready["backend"] == "cpu" and ready["primed"] > 0
    try:
        yield ready["port"]
    finally:
        try:
            with TCL.ServiceClient("127.0.0.1", ready["port"],
                                   retries=0) as c:
                c.shutdown()
            proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired, ValueError):
            pass
        _reap(proc)
        assert proc.returncode is not None


def _line(sock, f):
    ready, _, _ = select.select([sock], [], [], 30.0)
    assert ready, "no reply within 30 s"
    return json.loads(f.readline())


def test_wire_protocol(daemon):
    h = register_history(random.Random(4), 3, 20, p_info=0.0)
    bad = mutate(random.Random(2), register_history(random.Random(2), 3,
                                                    20, p_info=0.0))
    with socket.create_connection(("127.0.0.1", daemon), timeout=30) as s:
        f = s.makefile("rb")
        s.sendall(b'{"op": "ping", "id": 1}\n')
        assert _line(s, f) == {"ok": True, "pong": True, "id": 1}
        # one request split across sends is framed by its newline
        req = json.dumps({"op": "check", "id": 2,
                          "history": history_to_edn(list(h))}).encode()
        s.sendall(req[:17])
        time.sleep(0.05)
        s.sendall(req[17:] + b"\n")
        r = _line(s, f)
        assert r["ok"] and r["valid"] is True and r["id"] == 2
        assert set(r["stages"]) == {"queue_wait_ms", "host_pack_ms",
                                    "device_ms", "finalize_ms"}
        s.sendall(json.dumps({"op": "check", "id": 3, "history":
                              history_to_edn(list(bad))}).encode() + b"\n")
        r = _line(s, f)
        assert r["valid"] in (False, True) and "op_index" in r
        s.sendall(b"this is not json\n")
        r = _line(s, f)
        assert r["ok"] is False and r["error"] == "bad-request"
        s.sendall(b'{"op": "frobnicate", "id": 5}\n')
        r = _line(s, f)
        assert r["error"] == "bad-request" and r["id"] == 5
        s.sendall(b'{"op": "status", "id": 6}\n')
        st = _line(s, f)["status"]
        assert st["device"] == "cpu" and st["completed"] >= 2
        assert st["carry_reuses"] == 0
        s.sendall(b'{"op": "metrics", "id": 7}\n')
        m = _line(s, f)
        assert "service_completed_total" in m["prometheus"]
        assert "compile_kernel_builds_total" in m["prometheus"]


def test_client_disconnect_mid_request(daemon):
    h = register_history(random.Random(5), 3, 40, p_info=0.0)
    # one answered check first: a fresh daemon's first admission can
    # outlast the batch's fill window, and a reply sent before the daemon
    # has read the close is delivered, not dropped
    with TCL.ServiceClient("127.0.0.1", daemon) as c:
        assert c.check(list(h))["valid"] is True
    s = socket.create_connection(("127.0.0.1", daemon), timeout=30)
    s.sendall(json.dumps({"op": "check", "id": 1, "history":
                          history_to_edn(list(h))}).encode() + b"\n")
    s.close()                      # gone before the reply
    with TCL.ServiceClient("127.0.0.1", daemon) as c:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = c.status()["status"]
            if st["dropped_replies"] >= 1:
                break
            time.sleep(0.05)
        assert st["dropped_replies"] >= 1
        assert c.ping()
        r = c.check(list(h))
        assert r["valid"] is True


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


FILETEST_CASES = [
    (["txn", "clean.edn"], ["--checker", "txn"]),
    (["txn", "g2_item.edn"], ["--checker", "txn"]),
    (["txn", "g1c.edn"], ["--checker", "txn", "--realtime"]),
    (["wl", "bank_valid.edn"], ["--checker", "bank", "--wl-n", "8",
                                "--wl-total", "160"]),
    (["wl", "bank_wrong_total.edn"], ["--checker", "bank", "--wl-n", "8",
                                      "--wl-total", "160"]),
    (["wl", "sets_lost.edn"], ["--checker", "sets"]),
    (["shrink", "stale_read.edn"], []),
]


@pytest.mark.parametrize("parts,args", FILETEST_CASES,
                         ids=[p[-1] for p, _ in FILETEST_CASES])
def test_filetest_service_exit_codes(daemon, parts, args, capsys):
    path = os.path.join(FIX, *parts)
    got = torch_filetest.main([path, *args, "--service",
                               f"127.0.0.1:{daemon}"])
    want = jax_filetest.main([path, *args])
    capsys.readouterr()
    assert got == want and got in (0, 1)


def test_filetest_service_unreachable_exits_3(capsys):
    path = os.path.join(FIX, "txn", "clean.edn")
    port = _closed_port()
    args = [path, "--checker", "txn", "--service", f"127.0.0.1:{port}"]
    assert torch_filetest.main(list(args)) == 3
    assert jax_filetest.main(list(args)) == 3
    assert "verifier service error" in capsys.readouterr().err


def test_hash_ring_matches_and_remaps_about_one_nth():
    nodes = [f"sut/verifier/{i}" for i in range(4)]
    keys = [f"check|cas-register|{i}" for i in range(2000)]
    tr, jr = TCL.HashRing(nodes), JCL.HashRing(nodes)
    assert [tr.nodes_for(k) for k in keys[:200]] == \
        [jr.nodes_for(k) for k in keys[:200]]
    grown = TCL.HashRing(nodes + ["sut/verifier/4"])
    moved = sum(tr.nodes_for(k)[0] != grown.nodes_for(k)[0] for k in keys)
    # a fifth node takes about 1/5 of the keys, all of them its own
    assert 0.1 < moved / len(keys) < 0.3
    assert all(grown.nodes_for(k)[0] == "sut/verifier/4" for k in keys
               if tr.nodes_for(k)[0] != grown.nodes_for(k)[0])


def test_routed_client_over_a_fake_pmux(daemon, monkeypatch):
    import comdb2_tpu_torch.control.pmux as pmux_mod

    class _FakePmux:
        def __init__(self, *args, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def used(self):
            return {"sut/verifier/0": daemon, "sut/verifier.epoch": 3,
                    "other/service": 1}

        def get(self, name):
            return self.used().get(name)

    monkeypatch.setattr(pmux_mod, "PmuxClient", _FakePmux)
    rc = TCL.RoutedClient.discover(pmux_port=5105)
    try:
        assert list(rc.clients) == ["sut/verifier/0"]
        assert rc.epoch == 3
        h = register_history(random.Random(6), 3, 20, p_info=0.0)
        assert rc.check(list(h))["valid"] is True
        with open(os.path.join(FIX, "txn", "g2_item.edn")) as fh:
            r = rc.check(fh.read(), txn=True)
        assert r["valid"] is False and r["anomaly_class"]
    finally:
        rc.close()


def test_supervisor_reaps_what_it_retires():
    sup = TSUP.Supervisor(pmux_port=None, min_daemons=1, max_daemons=1,
                          daemon_args=["--backend", "cpu", "--no-prime"],
                          drain_grace_s=1.0, spawn_timeout_s=READY_TIMEOUT_S)
    child = sup.spawn()
    try:
        assert child.proc.poll() is None
        with TCL.ServiceClient("127.0.0.1", child.port) as c:
            assert c.ping()
    finally:
        sup.shutdown()
    assert child.proc.returncode is not None      # waited on: no zombie
    assert sup.retired == 1 and not sup.children
    for f in (child.proc.stdout, child.proc.stderr):
        if f is not None:
            f.close()


def test_desired_count_matches():
    from comdb2_tpu.service import supervisor as JSUP

    for args in ((1, 50.0, 5.0, 0), (2, 0.0, 10.0, 0), (2, 1.0, 100.0, 0),
                 (1, 0.0, 1.0, 60), (4, 500.0, 1.0, 0)):
        assert TSUP.desired_count(*args) == JSUP.desired_count(*args)


def test_cuda_backend_without_a_card_exits_before_ready():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc, ready = _spawn("--backend", "cuda", env=env)
    try:
        assert ready is None
        proc.wait(timeout=60)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr.read()
    finally:
        _reap(proc)
