"""The port's wire transactions (``comdb2_tpu_torch.workloads.tcp``:
``ClusterTxn``, ``TxnAborted`` and the bank, G2, dirty-reads,
list-append and counter txn clients) against the JAX package's — the
mirror of ``tests/test_txn_cluster.py``.

Request bytes: each package's txn client runs the same op against its
own scripted line server (``torch_cluster_parity.LineServer``) that
answers every verb the same way — or refuses the begin, aborts the
reads, fails, loses or leaves unknown the commit; the lines sent and
the completions must be equal. A commit's replay nonce carries a
per-session part drawn from the OS in both packages: the lines are
compared with its low 24 bits, the per-client sequence number.

Verdicts: the reference's runs against a live ``sut_node`` cluster
through the port's ``harness.core.run`` and the port's clients; each
history goes through the port's checker and, as the JAX package's ops,
the JAX package's — bank, G2, dirty reads, counter (host checkers),
``check_txn`` / ``Serializable`` on the host and on CPU tensors (the
closure), and ``check_wl_batch`` — with equal verdicts, anomalies and
cycles. Shortened against the reference (29 s on one core): the
harness runs last 3 s instead of 4 s, and the bank run under
partitions 4.5 s instead of 5.5 s; every assertion is kept.
"""

import random
import re

import pytest

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import workloads as JWK
from comdb2_tpu.checker.wl import check_wl_batch as jcheck_wl_batch
from comdb2_tpu.txn import check_txn as jcheck_txn
from comdb2_tpu.workloads import tcp as JT

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import workloads as TWK
from comdb2_tpu_torch.checker.wl import check_wl_batch
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import fake as TFAKE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.ops.op import Op
from comdb2_tpu_torch.txn import check_txn
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

TIMEOUT = 0.2
SESSION = 0x7A11


# --- request bytes: the txn clients -------------------------------------------

def _txn_responder(scenario, state):
    """Every verb answered the same way; ``scenario`` takes effect once
    ``state["armed"]`` is set (after the clients' set-up txns)."""
    def respond(line):
        verb = line.split()[0]
        armed = state.get("armed")
        if armed and scenario == "begin-refused" and verb == "TB":
            return "ERR no leader"
        if armed and scenario == "read-aborted" and verb in ("TR", "TP"):
            return "ERR conflict"
        if verb == "TB":
            return "T 7"
        if verb == "TR":
            return "V 10"
        if verb == "TP":
            return "V 1:30 2:4" if scenario == "rows" else "V"
        if verb == "TC" and armed:
            reply = {"commit-fail": "FAIL", "commit-unknown": "UNKNOWN",
                     "commit-lost": CP.SILENT}.get(scenario)
            if reply is not None:
                return reply
        if verb == "TC":
            return "OK 9"
        return "OK"
    return respond


TXN_SCENARIOS = ["ok", "rows", "commit-fail", "commit-unknown",
                 "commit-lost", "read-aborted", "begin-refused"]

TXN_OPS = {
    "bank-read": ("BankTcpClient", dict(n=3), ("read", None)),
    "bank-transfer": ("BankTcpClient", dict(n=3),
                      ("transfer", {"from": 0, "to": 2, "amount": 3})),
    "bank-overdraw": ("BankTcpClient", dict(n=3),
                      ("transfer", {"from": 1, "to": 0, "amount": 20})),
    "g2-a": ("G2TcpClient", {}, ("insert", (4, (11, None)))),
    "g2-b": ("G2TcpClient", {}, ("insert", (4, (None, 12)))),
    "dirty-read": ("DirtyReadsTcpClient", dict(n=3), ("read", None)),
    "dirty-write": ("DirtyReadsTcpClient", dict(n=3), ("write", 5)),
    "list-append": ("ListAppendTcpClient", {},
                    ("txn", (("append", 0, 5), ("r", 0, None),
                             ("r", 1, None), ("append", 1, 6)))),
    "counter-read": ("CounterTcpClient", {}, ("read", None)),
    "counter-add": ("CounterTcpClient", {}, ("add", 3)),
}


def _nonce_seq(line):
    """A commit line with its nonce cut to the per-client sequence."""
    m = re.match(r"^TC (\d+) (\d+)$", line)
    if m:
        return f"TC {m.group(1)} seq={int(m.group(2)) & 0xFFFFFF}"
    return line


def _txn_once(T, case, scenario):
    cls, kw, (f, value) = TXN_OPS[case]
    state = {}
    with CP.LineServer(_txn_responder(scenario, state)) as s:
        c = getattr(T, cls)([s.port], timeout_s=TIMEOUT, **kw).setup(
            {}, None)
        c._session = SESSION
        state["armed"] = True
        random.seed(5)              # the dirty write's row order
        try:
            done = c.invoke({}, {"type": "invoke", "f": f, "value": value,
                                 "process": 1})
        finally:
            c.teardown({})
        return [(n, _nonce_seq(line)) for _, n, line
                in CP.recorded([s])], done


@pytest.mark.parametrize("scenario", TXN_SCENARIOS)
@pytest.mark.parametrize("case", list(TXN_OPS))
def test_txn_client_request_bytes_and_completion(case, scenario):
    got = _txn_once(TT, case, scenario)
    want = _txn_once(JT, case, scenario)
    assert got[0] == want[0]
    assert P.plain(got[1]) == P.plain(want[1])


def _cluster_txn_once(T, scenario):
    """The ClusterTxn verbs one by one; each verb's outcome, or the
    exception class and message it raised."""
    state = {"armed": True}
    out = []
    with CP.LineServer(_txn_responder(scenario, state)) as s:
        conn = CP.connect(T.SutConnection, s.port, timeout=TIMEOUT)
        t = T.ClusterTxn(conn)
        for verb, args in (("begin", ()), ("read", (3,)),
                           ("predicate", ("a", 3)), ("write", (3, 4)),
                           ("insert", ("b", 3, 17, 30)),
                           ("commit", (99,)), ("abort", ())):
            try:
                out.append((verb, getattr(t, verb)(*args)))
            except (T.TxnAborted, TimeoutError) as e:
                out.append((verb, type(e).__name__, str(e)))
        conn.close()
        return CP.recorded([s]), out


@pytest.mark.parametrize("scenario", TXN_SCENARIOS)
def test_cluster_txn_verbs_equal_the_references(scenario):
    assert _cluster_txn_once(TT, scenario) == \
        _cluster_txn_once(JT, scenario)


# --- the reference's runs against a live cluster ------------------------------

def _cluster(**kw):
    return CP.cluster(TT.spawn_cluster, 3, durable=True, **kw)


def _held(jax_checker, result, model=None):
    """The port's result equals the JAX package's checker's on the
    same history; returns the port's results."""
    res = result["results"]
    want = jax_checker.check(None, model, P.to_jax(result["history"]))
    assert P.plain(res) == P.plain(want)
    return res


@CP.needs_sut_node
def test_txn_commit_applies_atomically():
    with _cluster(timeout_ms=800) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            t = TT.ClusterTxn(conn)
            t.begin()
            assert t.read(1) is None
            t.write(1, 10)
            t.write(2, 20)
            assert t.commit() == "ok"
            assert conn.request("R 1") == "V 10"
            assert conn.request("R 2") == "V 20"
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            assert t2.read(1) == 10
            assert t2.read(2) == 20
            assert t2.commit() == "ok"
        finally:
            conn.close()


@CP.needs_sut_node
@pytest.mark.parametrize("buggy", [False, True])
def test_txn_occ_conflict_aborts_second(buggy):
    """The first commit wins, the second fails validation; with ``-T``
    both commit (the lost update)."""
    with _cluster(timeout_ms=800,
                  flags=["-T"] if buggy else []) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            t0 = TT.ClusterTxn(conn)
            t0.begin()
            t0.write(1, 100)
            assert t0.commit() == "ok"
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            b1 = t1.read(1)
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            b2 = t2.read(1)
            assert b1 == b2 == 100
            t1.write(1, b1 - 30)
            t2.write(1, b2 - 50)
            assert t1.commit() == "ok"
            second = t2.commit()
            assert second == ("ok" if buggy else "fail")
            assert conn.request("R 1") == ("V 50" if buggy else "V 70")
        finally:
            conn.close()


@CP.needs_sut_node
@pytest.mark.parametrize("buggy", [False, True])
def test_txn_predicate_phantom_detected(buggy):
    """Two txns predicate-read (a, k) and (b, k) empty and both insert:
    validation fails the second; with ``-T`` both commit and both
    packages' G2 checkers flag the key."""
    with _cluster(timeout_ms=800,
                  flags=["-T"] if buggy else []) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            k = 7
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            assert t1.predicate("a", k) == []
            assert t1.predicate("b", k) == []
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            assert t2.predicate("a", k) == []
            assert t2.predicate("b", k) == []
            t1.insert("a", k, 1, 30)
            t2.insert("b", k, 2, 30)
            assert t1.commit() == "ok"
            second = t2.commit()
        finally:
            conn.close()
    outcome = "ok" if second == "ok" else "fail"
    history = [
        Op(process=0, type="invoke", f="insert", value=(k, (1, None)),
           time=0),
        Op(process=0, type="ok", f="insert", value=(k, (1, None)), time=1),
        Op(process=1, type="invoke", f="insert", value=(k, (None, 2)),
           time=2),
        Op(process=1, type=outcome, f="insert", value=(k, (None, 2)),
           time=3)]
    res = TWK.g2_checker.check(None, None, history)
    assert P.plain(res) == P.plain(
        JWK.g2_checker.check(None, None, P.to_jax(history)))
    assert second == ("ok" if buggy else "fail")
    assert res["valid?"] is (not buggy), res


def _bank_test(tmp_path, ports, name, n=5, **kw):
    t = TFAKE.noop_test(device="cpu")
    t.update({
        "nodes": [], "concurrency": 5, "name": name,
        "store-root": str(tmp_path / "store"),
        "client": TT.BankTcpClient(ports, n=n, timeout_s=0.6),
        "model": {"n": n, "total": n * 10},
        "_bank_n": n,
        "generator": TG.clients(TG.time_limit(3.0, TG.stagger(
            0.01, TG.mix([TW.bank_read, TW.bank_diff_transfer])))),
        "checker": TWK.bank_checker,
    })
    t.update(kw)
    return t


@CP.needs_sut_node
def test_bank_over_cluster_valid(tmp_path):
    with _cluster(timeout_ms=500) as (ports, _):
        t = _bank_test(tmp_path, ports, "bank-cluster")
        result = TCORE.run(t)
    res = _held(JWK.bank_checker, result, t["model"])
    assert res["valid?"] is True, res
    h = result["history"]
    reads = [op for op in h if op.type == "ok" and op.f == "read"]
    xfers = [op for op in h if op.type == "ok" and op.f == "transfer"]
    assert len(reads) >= 20 and len(xfers) >= 10, (len(reads), len(xfers))


@CP.needs_sut_node
def test_bank_over_cluster_valid_under_partition(tmp_path):
    """The total holds under partition windows that force failovers."""
    with _cluster(timeout_ms=300, elect_ms=500,
                  lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        steps = [TG.sleep(0.4), {"type": "info", "f": "start"},
                 TG.sleep(1.0), {"type": "info", "f": "stop"},
                 TG.sleep(0.5), {"type": "info", "f": "start"},
                 TG.sleep(1.0), {"type": "info", "f": "stop"}]
        t = _bank_test(
            tmp_path, ports, "bank-cluster-nemesis",
            nemesis=TT.ClusterPartitioner(ctl, isolate_primary=True),
            generator=TG.nemesis(TG.seq(steps), TG.time_limit(
                4.5, TG.stagger(0.01, TG.mix([TW.bank_read,
                                              TW.bank_diff_transfer])))))
        try:
            result = TCORE.run(t)
        finally:
            ctl.heal()
    res = _held(JWK.bank_checker, result, t["model"])
    assert res["valid?"] is True, res
    assert len([op for op in result["history"]
                if op.type == "ok" and op.f == "read"]) >= 10


@CP.needs_sut_node
def test_bank_buggy_txn_control_detected():
    """``-T``, deterministic: two transfers sharing one account read it
    at the same snapshot; the second commit clobbers it and the total
    drifts, INVALID through both packages' bank checkers."""
    with _cluster(timeout_ms=800, flags=["-T"]) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            init = TT.ClusterTxn(conn)
            init.begin()
            for i in range(3):
                init.write(i, 10)
            assert init.commit() == "ok"
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            a0, a1 = t1.read(0), t1.read(1)
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            b1, b2 = t2.read(1), t2.read(2)
            assert a1 == b1 == 10
            t1.write(0, a0 - 5)
            t1.write(1, a1 + 5)
            t2.write(1, b1 - 3)
            t2.write(2, b2 + 3)
            assert t1.commit() == "ok"
            assert t2.commit() == "ok"
            rd = TT.ClusterTxn(conn)
            rd.begin()
            balances = tuple(rd.read(i) for i in range(3))
            rd.commit()
        finally:
            conn.close()
    history = [Op(process=0, type="invoke", f="read", value=None, time=0),
               Op(process=0, type="ok", f="read", value=balances, time=1)]
    model = {"n": 3, "total": 30}
    res = TWK.bank_checker.check(None, model, history)
    assert P.plain(res) == P.plain(
        JWK.bank_checker.check(None, model, P.to_jax(history)))
    assert sum(balances) != 30, balances
    assert res["valid?"] is False, (balances, res)


def _plain_test(tmp_path, ports, name, client, generator, checker,
                concurrency=5):
    t = TFAKE.noop_test(device="cpu")
    t.update({"nodes": [], "concurrency": concurrency, "name": name,
              "store-root": str(tmp_path / "store"), "client": client,
              "model": None, "generator": generator, "checker": checker})
    return t


@CP.needs_sut_node
def test_g2_over_cluster_valid(tmp_path):
    """At most one insert commits per key; the count is not vacuous."""
    with _cluster(timeout_ms=500) as (ports, _):
        result = TCORE.run(_plain_test(
            tmp_path, ports, "g2-cluster",
            TT.G2TcpClient(ports, timeout_s=0.6),
            TG.clients(TG.time_limit(3.0, TW.g2_gen())), TWK.g2_checker,
            concurrency=6))
    res = _held(JWK.g2_checker, result)
    assert res["valid?"] is True, res
    assert res["legal-count"] >= 5, res


@CP.needs_sut_node
def test_dirty_reads_over_cluster_valid(tmp_path):
    """No failed write's value is read; every committed read uniform."""
    with _cluster(timeout_ms=500) as (ports, _):
        result = TCORE.run(_plain_test(
            tmp_path, ports, "dirty-cluster",
            TT.DirtyReadsTcpClient(ports, n=4, timeout_s=0.6),
            TG.clients(TG.time_limit(3.0, TG.stagger(0.01, TG.mix(
                [TW.dirty_reads_read, TW._DirtyWrites()])))),
            TWK.dirty_reads_checker))
    res = _held(JWK.dirty_reads_checker, result)
    assert res["valid?"] is True, res
    assert res["inconsistent-reads"] == [], res
    assert len([op for op in result["history"]
                if op.type == "ok" and op.f == "read"]) >= 10


def _dirty_interleave(conn, base=10_000, n=3):
    """W1 and W2 conflict; returns the second commit's verdict and the
    rows a later read sees (``-R``: ('fail', the loser's values))."""
    init = TT.ClusterTxn(conn)
    init.begin()
    for i in range(n):
        init.write(base + i, -1)
    assert init.commit() == "ok"
    t1 = TT.ClusterTxn(conn)
    t1.begin()
    t2 = TT.ClusterTxn(conn)
    t2.begin()
    for i in range(n):
        t1.read(base + i)
        t2.read(base + i)
    for i in range(n):
        t1.write(base + i, 7)
        t2.write(base + i, 8)
    assert t1.commit() == "ok"
    second = t2.commit()
    rd = TT.ClusterTxn(conn)
    rd.begin()
    seen = tuple(rd.read(base + i) for i in range(n))
    rd.commit()
    return second, seen


def _dirty_wl_history(second, seen):
    return [
        Op(process=0, type="invoke", f="write", value=7, time=0),
        Op(process=0, type="ok", f="write", value=7, time=1),
        Op(process=1, type="invoke", f="write", value=8, time=2),
        Op(process=1, type=("ok" if second == "ok" else "fail"),
           f="write", value=8, time=3),
        Op(process=2, type="invoke", f="read", value=None, time=4),
        Op(process=2, type="ok", f="read", value=seen, time=5),
    ]


@CP.needs_sut_node
def test_dirty_reads_dirty_commit_control_detected():
    """``-R``: the conflicted write reports FAIL but applies; a read
    sees it, INVALID through both packages. A conflicted read-only txn
    still fails cleanly."""
    with _cluster(timeout_ms=800, flags=["-R"]) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            second, seen = _dirty_interleave(conn)
            assert second == "fail"
            assert seen == (8, 8, 8), seen
            base = 10_000
            w, ro = TT.ClusterTxn(conn), TT.ClusterTxn(conn)
            ro.begin()
            ro.read(base)
            w.begin()
            w.write(base, 9)
            assert w.commit() == "ok"
            assert ro.commit() == "fail"
        finally:
            conn.close()
    history = _dirty_wl_history(second, seen)
    res = TWK.dirty_reads_checker.check(None, None, history)
    assert P.plain(res) == P.plain(JWK.dirty_reads_checker.check(
        None, None, P.to_jax(history)))
    assert res["valid?"] is False, res
    assert res["dirty-reads"], res


@CP.needs_sut_node
@pytest.mark.parametrize("dirty", [True, False])
def test_dirty_commit_through_wl_family_end_to_end(dirty):
    """The ``-R`` control (and the healthy twin) through the port's
    device dirty-reads family on CPU tensors, the JAX package's, and
    the host oracle: verdicts and dirty reads equal."""
    flags, base = (["-R"], 10_000) if dirty else ([], 20_000)
    with _cluster(timeout_ms=800, flags=flags) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            second, seen = _dirty_interleave(conn, base=base)
        finally:
            conn.close()
    assert second == "fail"
    assert seen == ((8, 8, 8) if dirty else (7, 7, 7)), seen
    history = _dirty_wl_history(second, seen)
    dev = check_wl_batch([history], "dirty", device="cpu")[0]
    jdev = jcheck_wl_batch([P.to_jax(history)], "dirty")[0]
    host = TWK.dirty_reads_checker.check(None, None, history)
    assert dev["valid?"] is jdev["valid?"] is host["valid?"] is (not dirty)
    assert sorted(map(tuple, dev["dirty-reads"])) == \
        sorted(map(tuple, jdev["dirty-reads"])) == \
        sorted(tuple(r) for r in host["dirty-reads"])
    if not dirty:
        assert dev["dirty-reads"] == [] and dev["inconsistent-reads"] == []


def _counter_add(test=None, process=None):
    return {"type": "invoke", "f": "add", "value": random.randint(1, 5)}


def _counter_read(test=None, process=None):
    return {"type": "invoke", "f": "read", "value": None}


@CP.needs_sut_node
def test_counter_over_cluster_valid(tmp_path):
    with _cluster(timeout_ms=500) as (ports, _):
        result = TCORE.run(_plain_test(
            tmp_path, ports, "counter-cluster",
            TT.CounterTcpClient(ports, timeout_s=0.6),
            TG.clients(TG.time_limit(3.0, TG.stagger(0.01, TG.mix(
                [_counter_add, _counter_read])))), TC.counter))
    res = _held(JC.counter, result)
    assert res["valid?"] is True, res
    assert len(res["reads"]) >= 10, res
    assert len([op for op in result["history"]
                if op.type == "ok" and op.f == "add"]) >= 10


@CP.needs_sut_node
def test_counter_buggy_txn_lost_update_detected():
    """``-T``: two adds from one snapshot both commit; the later read
    sits below both packages' lower bound."""
    with _cluster(timeout_ms=800, flags=["-T"]) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            key = TT.CounterTcpClient.KEY
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            a = t1.read(key) or 0
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            b = t2.read(key) or 0
            t1.write(key, a + 5)
            t2.write(key, b + 5)
            assert t1.commit() == "ok"
            assert t2.commit() == "ok"
            rd = TT.ClusterTxn(conn)
            rd.begin()
            v = rd.read(key)
            rd.commit()
        finally:
            conn.close()
    assert v == 5, v
    history = [
        Op(process=0, type="invoke", f="add", value=5, time=0),
        Op(process=0, type="ok", f="add", value=5, time=1),
        Op(process=1, type="invoke", f="add", value=5, time=2),
        Op(process=1, type="ok", f="add", value=5, time=3),
        Op(process=2, type="invoke", f="read", value=None, time=4),
        Op(process=2, type="ok", f="read", value=v, time=5)]
    res = TC.counter.check(None, None, history)
    assert P.plain(res) == P.plain(
        JC.counter.check(None, None, P.to_jax(history)))
    assert res["valid?"] is False, res


def _txn_both(history):
    """``check_txn`` of the port on the host and on CPU tensors (the
    closure), equal to the JAX package's on the host; returns the
    port's host result."""
    want = jcheck_txn(P.to_jax(history), backend="host")
    host = check_txn(history, backend="host", device="cpu")
    dev = check_txn(history, backend="device", device="cpu")
    assert host == want
    assert dev == want
    return host


@CP.needs_sut_node
def test_list_append_over_cluster_valid(tmp_path):
    """The harness list-append workload over a clean cluster passes the
    dependency-graph checker of both packages, on the host and through
    the closure on CPU tensors."""
    with _cluster(timeout_ms=500, elect_ms=500,
                  lease_ms=300) as (ports, _):
        result = TCORE.run(_plain_test(
            tmp_path, ports, "la-cluster",
            TT.ListAppendTcpClient(ports, timeout_s=0.6),
            TG.clients(TG.time_limit(3.0, TG.stagger(
                0.01, TW.list_append_gen(n_keys=3)))),
            TC.Serializable(backend="host", device="cpu")))
    res = _held(JC.Serializable(backend="host"), result)
    assert res == _txn_both(result["history"])
    assert res["valid?"] is True, res
    assert res["txn-count"] >= 20, res
    assert res["edge-count"] >= 10, res


@CP.needs_sut_node
@pytest.mark.parametrize("buggy", [True, False])
def test_buggy_txn_control_yields_g2_cycle(buggy):
    """``-T``, deterministic write skew: both txns commit and both
    packages find the rw/rw cycle and class it G2-item; on a correct
    cluster one txn aborts and the history checks valid."""
    base = TT.ListAppendTcpClient.BASE
    with _cluster(timeout_ms=800,
                  flags=["-T"] if buggy else []) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            r1 = tuple(v for _r, v in t1.predicate("a", base + 0))
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            r2 = tuple(v for _r, v in t2.predicate("a", base + 1))
            assert r1 == r2 == ()
            t1.insert("a", base + 1, 1, 1)
            t2.insert("a", base + 0, 2, 2)
            assert t1.commit() == "ok"
            second = t2.commit()
            rd = TT.ClusterTxn(conn)
            rd.begin()
            fx = tuple(v for _r, v in rd.predicate("a", base + 0))
            fy = tuple(v for _r, v in rd.predicate("a", base + 1))
            rd.commit()
        finally:
            conn.close()
    hist = [
        Op(0, "invoke", "txn", (("r", 0, None), ("append", 1, 1))),
        Op(0, "ok", "txn", (("r", 0, r1), ("append", 1, 1))),
        Op(1, "invoke", "txn", (("r", 1, None), ("append", 0, 2))),
        Op(1, "ok" if second == "ok" else "fail", "txn",
           (("r", 1, r2), ("append", 0, 2))),
        Op(2, "invoke", "txn", (("r", 0, None), ("r", 1, None))),
        Op(2, "ok", "txn", (("r", 0, fx), ("r", 1, fy)))]
    res = _txn_both(hist)
    if buggy:
        assert second == "ok"
        assert fx == (2,) and fy == (1,)
        assert res["valid?"] is False, res
        assert res["counterexample"]["class"] == "G2-item", res
        assert {s["edge"]["type"]
                for s in res["counterexample"]["cycle"]} == {"rw"}
    else:
        assert second == "fail"
        assert res["valid?"] is True, res


@CP.needs_sut_node
def test_dirty_commit_control_yields_g1a_and_cycle():
    """``-R``, deterministic: the failed append is applied and read;
    both packages flag G1a and the G2-item cycle through the dirty
    txn."""
    k = TT.ListAppendTcpClient.BASE + 5
    with _cluster(timeout_ms=800, flags=["-R"]) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            t1 = TT.ClusterTxn(conn)
            t1.begin()
            r1 = tuple(v for _r, v in t1.predicate("a", k))
            t2 = TT.ClusterTxn(conn)
            t2.begin()
            r2 = tuple(v for _r, v in t2.predicate("a", k))
            assert r1 == r2 == ()
            t1.insert("a", k, 1, 1)
            t2.insert("a", k, 2, 2)
            assert t1.commit() == "ok"
            assert t2.commit() == "fail"
            rd = TT.ClusterTxn(conn)
            rd.begin()
            seen = tuple(v for _r, v in rd.predicate("a", k))
            rd.commit()
        finally:
            conn.close()
    assert seen == (1, 2), seen
    hist = [
        Op(0, "invoke", "txn", (("r", 5, None), ("append", 5, 1))),
        Op(0, "ok", "txn", (("r", 5, r1), ("append", 5, 1))),
        Op(1, "invoke", "txn", (("r", 5, None), ("append", 5, 2))),
        Op(1, "fail", "txn", (("r", 5, r2), ("append", 5, 2))),
        Op(2, "invoke", "txn", (("r", 5, None),)),
        Op(2, "ok", "txn", (("r", 5, seen),))]
    res = _txn_both(hist)
    assert res["valid?"] is False, res
    assert any(a["name"] == "G1a" for a in res["anomalies"]), res
    assert res["counterexample"]["class"] == "G2-item", res
    assert "fail (dirty)" in {s["status"]
                              for s in res["counterexample"]["cycle"]}


@pytest.mark.parametrize("kind", ["g2", "dirty"])
@pytest.mark.parametrize("bad", [True, False])
def test_second_opinions_agree_on_seeded_controls(kind, bad):
    """The composed (bespoke + graph) checkers of both packages agree
    on the seeded ``-T`` G2 and ``-R`` dirty-read interleavings, the
    anomalous and the healthy variant."""
    if kind == "g2":
        hist = [Op(0, "invoke", "insert", (7, (1, None))),
                Op(0, "ok", "insert", (7, (1, None))),
                Op(1, "invoke", "insert", (7, (None, 2))),
                Op(1, "ok", "insert", (7, (None, 2)))]
        if not bad:
            hist[3] = hist[3].with_(type="fail")
        checker, jchecker, inner = (TWK.g2_composed(), JWK.g2_composed(),
                                    "adya")
    else:
        hist = [Op(0, "invoke", "write", 7), Op(0, "ok", "write", 7),
                Op(1, "invoke", "write", 8), Op(1, "fail", "write", 8),
                Op(2, "invoke", "read", None),
                Op(2, "ok", "read", (8, 8) if bad else (7, 7))]
        checker, jchecker, inner = (TWK.dirty_reads_composed(),
                                    JWK.dirty_reads_composed(), "dirty")
    res = checker.check(None, None, hist)
    assert P.plain(res) == P.plain(jchecker.check(None, None,
                                                  P.to_jax(hist)))
    assert res["valid?"] is (not bad), res
    assert res[inner]["valid?"] is (not bad)
    assert res["graph"]["valid?"] is (not bad)


def test_txn_aborted_is_a_plain_exception():
    """A txn verb that fails server-side raises the port's own
    ``TxnAborted`` (an ``Exception``, as in the JAX package)."""
    assert issubclass(TT.TxnAborted, Exception)
    assert TT.TxnAborted is not JT.TxnAborted
