"""The port's TCP SUT client (``comdb2_tpu_torch.workloads.tcp``:
``SutConnection``, ``TcpRegisterClient``, ``spawn_server``) against the
JAX package's — the mirror of ``tests/test_tcp_sut.py``.

Request bytes: each package's client talks to its own scripted line
server (``torch_cluster_parity.LineServer``) with the same op and the
same replies; the lines they send and the completions they record must
be equal, for every reply shape the server can give (a value, ok, fail,
garbage, silence until the timeout, a reply cut mid-line, a closed
connection).

Verdicts: the harness loop of ``tests/test_tcp_sut.py`` through the
port's ``harness.core.run`` against the native ``sut_server``; each
recorded history goes through the port's checker and, as the JAX
package's ops, through the JAX package's: the result maps must be equal
(``torch_harness_parity.plain``). One run of the JAX package's harness
goes through the port's checker the same way. The linearizability
checks run on the host engine, as the reference test's do.
"""

import signal

import pytest

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.harness import core as JCORE
from comdb2_tpu.harness import fake as JFAKE
from comdb2_tpu.harness import generator as JG
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import kv as JKV
from comdb2_tpu.workloads import comdb2 as JW
from comdb2_tpu.workloads import tcp as JT

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import fake as TFAKE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import kv as TKV
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

TIMEOUT = 0.2

OPS = {"read": ("read", (1, None)), "write": ("write", (1, 3)),
       "cas": ("cas", (1, (3, 4)))}
REPLIES = {"ok": "OK", "ok-lsn": "OK 12", "fail": "FAIL", "nil": "NIL",
           "value": "V 3", "garbage": "ERR boom", "silent": CP.SILENT,
           "truncated": CP.Truncated("V 1"), "closed": CP.CLOSE}


def _op(kv, name):
    f, (k, v) = OPS[name]
    return {"type": "invoke", "f": f, "value": kv.tuple_(k, v),
            "process": 0}


def _register_once(T, kv, op_name, reply):
    """One op through package ``T``'s ``TcpRegisterClient`` against a
    server answering every line with ``reply``: (lines, completion)."""
    with CP.LineServer(lambda line: reply) as s:
        c = T.TcpRegisterClient(port=s.port, timeout_s=TIMEOUT).setup(
            {}, None)
        try:
            done = c.invoke({}, _op(kv, op_name))
        finally:
            c.teardown({})
        return CP.recorded([s]), done


@pytest.mark.parametrize("reply", list(REPLIES))
@pytest.mark.parametrize("op_name", list(OPS))
def test_register_client_request_bytes_and_completion(op_name, reply):
    got = _register_once(TT, TKV, op_name, REPLIES[reply])
    want = _register_once(JT, JKV, op_name, REPLIES[reply])
    assert got[0] == want[0]
    assert P.plain(got[1]) == P.plain(want[1])


@pytest.mark.parametrize("reply", ["value", "silent", "truncated",
                                   "closed"])
def test_sut_connection_outcomes(reply):
    """A reply, or the same ``TimeoutError`` with the same message."""
    out = []
    for T in (TT, JT):
        with CP.LineServer(lambda line: REPLIES[reply]) as s:
            conn = T.SutConnection("127.0.0.1", s.port, timeout_s=TIMEOUT)
            try:
                out.append(("reply", conn.request("R 1")))
            except TimeoutError as e:
                out.append(("timeout", str(e)))
            finally:
                conn.close()
    assert out[0] == out[1]
    assert (out[0][0] == "reply") == (reply == "value")


# --- the harness loop against sut_server ------------------------------------

@pytest.fixture
def server():
    for i in range(3):
        port = CP.free_ports(1)[0]
        try:
            proc = TT.spawn_server(CP.SUT_SERVER, port)
            break
        except RuntimeError:
            if i == 2:
                raise
    try:
        yield port, proc
    finally:
        CP.kill([proc])


def _tcp_test(tmp_path, port, **kw):
    t = TFAKE.noop_test(device="cpu")
    t.update({
        "nodes": [], "concurrency": 5, "name": "tcp-register",
        "store-root": str(tmp_path / "store"),
        "client": TT.TcpRegisterClient(port=port, timeout_s=0.5),
        "model": TM.cas_register(),
        "generator": TG.clients(TG.limit(
            100, TG.mix([TW.r, TW.w, TW.cas]))),
        "checker": TI.checker(TC.Linearizable(backend="host",
                                              device="cpu")),
    })
    t.update(kw)
    return t


def _jax_checker():
    return JI.checker(JC.Linearizable(backend="host"))


def _held(result, tmp_path):
    """The port's result equals the JAX package's checker on the same
    history; returns the port's results."""
    want = _jax_checker().check({"name": "jax", "dir": str(tmp_path / "j")},
                                JM.cas_register(),
                                P.to_jax(result["history"]))
    assert P.plain(result["results"]) == P.plain(want)
    return result["results"]


@CP.needs_sut_server
def test_tcp_register_run_valid(tmp_path, server):
    port, _proc = server
    result = TCORE.run(_tcp_test(tmp_path, port))
    res = _held(result, tmp_path)
    assert res["valid?"] is True, res
    oks = [op for op in result["history"] if op.type == "ok"]
    assert len(oks) >= 50


@CP.needs_sut_server
def test_jax_harness_history_through_the_ports_checker(tmp_path, server):
    """The JAX package's harness and client over the same server; its
    history through the port's checker gives the JAX package's
    result."""
    port, _proc = server
    t = JFAKE.noop_test()
    t.update({
        "nodes": [], "concurrency": 5, "name": "tcp-register-jax",
        "store-root": str(tmp_path / "store"),
        "client": JT.TcpRegisterClient(port=port, timeout_s=0.5),
        "model": JM.cas_register(),
        "generator": JG.clients(JG.limit(100, JG.mix([JW.r, JW.w,
                                                       JW.cas]))),
        "checker": _jax_checker(),
    })
    result = JCORE.run(t)
    got = TI.checker(TC.Linearizable(backend="host", device="cpu")).check(
        {"name": "port", "dir": str(tmp_path / "p")}, TM.cas_register(),
        P.to_torch(result["history"]))
    assert P.plain(got) == P.plain(result["results"])
    assert got["valid?"] is True, got


@CP.needs_sut_server
def test_tcp_register_sigstop_yields_info_ops(tmp_path, server):
    """SIGSTOP the server mid-run: requests time out, workers record
    info ops and retire processes, and the history stays linearizable
    once the server resumes."""
    port, proc = server

    class Stopper(TFAKE.client_ns.Client):
        def invoke(self, test, op):
            if op["f"] == "start":
                proc.send_signal(signal.SIGSTOP)
            else:
                proc.send_signal(signal.SIGCONT)
            return dict(op)

    t = _tcp_test(
        tmp_path, port,
        nemesis=Stopper(),
        generator=TG.nemesis(
            TG.seq([TG.sleep(0.2), {"type": "info", "f": "start"},
                    TG.sleep(1.2), {"type": "info", "f": "stop"}]),
            TG.stagger(0.01, TG.limit(120, TG.mix([TW.r, TW.w, TW.cas])))))
    try:
        result = TCORE.run(t)
    finally:
        proc.send_signal(signal.SIGCONT)
    res = _held(result, tmp_path)
    assert res["valid?"] is True, res
    infos = [op for op in result["history"]
             if op.type == "info" and op.process != "nemesis"]
    assert infos, "SIGSTOP window should have produced timeouts"


@CP.needs_sut_server
def test_tcp_buggy_server_detected(tmp_path):
    """The negative control over the wire: a buggy server must be
    flagged invalid by both packages' checkers. Detection depends on
    op interleaving, so as in the reference, a few rounds."""
    for attempt in range(3):
        port = CP.free_ports(1)[0]
        proc = TT.spawn_server(CP.SUT_SERVER, port, "-B")
        try:
            t = _tcp_test(tmp_path, port, name=f"tcp-buggy-{attempt}")
            t["generator"] = TG.clients(
                TG.limit(250, TG.mix([TW.r, TW.r, TW.w, TW.cas])))
            result = TCORE.run(t)
            if _held(result, tmp_path)["valid?"] is False:
                return
        finally:
            CP.kill([proc])
    raise AssertionError(
        "buggy server never produced a detectable violation in 3 runs")
