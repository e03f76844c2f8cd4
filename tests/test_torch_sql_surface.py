"""The port's SQL-text clients (``comdb2_tpu_torch.workloads.sql``:
``SqlTxn``, ``SqlClusterRegisterClient``, ``SqlG2Client``) against the
JAX package's — the mirror of ``tests/test_sql_surface.py``.

Statement bytes: each package's client runs the same op against its own
scripted line servers (``torch_cluster_parity.LineServer``) answering
the statements the same way (rowcounts, misses, a refused ``set
cnonce``, a silent node, a transaction left open, a failed or lost
commit); the statements sent and the completions must be equal. The
per-session nonce is drawn from the OS in both packages, so both are
given the same one after set-up.

Verdicts: the reference's runs against a live ``sut_node`` through the
port's ``harness.core.run``; each history through the port's checker
and, as the JAX package's ops, the JAX package's, with equal results.
Shortened against the reference: the register and G2 runs last 2.5 s
instead of 3 s; every assertion is kept.
"""

import os
import random
import subprocess

import pytest

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.checker.workloads import g2_checker as jg2_checker
from comdb2_tpu.models.model import cas_register as jcas_register
from comdb2_tpu.ops import kv as JKV
from comdb2_tpu.workloads import sql as JSQL
from comdb2_tpu.workloads import tcp as JT

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.checker.workloads import g2_checker
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import fake as TFAKE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import kv as TKV
from comdb2_tpu_torch.ops.op import Op
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import sql as TSQL
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

TIMEOUT = 0.2
SESSION = 0x501


def test_session_sets_equal_the_references():
    assert TSQL.SESSION_SETS == JSQL.SESSION_SETS


# --- statement bytes -----------------------------------------------------------

def _sql_responder(scenario, i, state):
    def respond(line):
        armed = state.get("armed")
        s = line.lower()
        if armed and scenario == "first-silent" and i == 0:
            return CP.SILENT
        if s.startswith("set cnonce") and armed \
                and scenario == "cnonce-refused" and i == 0:
            return "ERR cnonce"
        if s.startswith("set "):
            return "OK"
        if s.startswith("select val from register"):
            return "NIL" if scenario == "nil" else "V 2"
        if s.startswith("select id, v from"):
            return "V 5:30 6:4" if scenario == "rows" else "V"
        if s.startswith("insert into register"):
            return "ERR busy" if scenario == "unknown" else "ROWS 1"
        if s.startswith("update register"):
            return {"cas-miss": "ROWS 0", "unknown": "ERR busy"}.get(
                scenario, "ROWS 1")
        if s.startswith("insert into"):
            return "ROWS 1"
        if s == "begin":
            if scenario == "already-open" and not state.get("reopened"):
                state["reopened"] = True
                return "ERR transaction already open"
            return "OK"
        if s == "commit":
            return {"commit-fail": "FAIL", "commit-lost": CP.SILENT,
                    "commit-unknown": "UNKNOWN"}.get(scenario, "OK 4")
        if s == "rollback":
            return "OK"
        return "ERR parse"
    return respond


REGISTER_SCENARIOS = ["ok", "nil", "cas-miss", "unknown", "first-silent",
                      "cnonce-refused"]
REGISTER_OPS = {"read": ("read", (3, None)), "write": ("write", (3, 1)),
                "cas": ("cas", (3, (1, 2)))}


def _register_once(S, kv, scenario, op_name):
    state = {}
    with CP.line_servers([_sql_responder(scenario, i, state)
                          for i in range(3)]) as servers:
        c = S.SqlClusterRegisterClient([s.port for s in servers],
                                       timeout_s=TIMEOUT).setup({}, None)
        c._session = SESSION
        state["armed"] = True
        f, (k, v) = REGISTER_OPS[op_name]
        try:
            done = c.invoke({}, {"type": "invoke", "f": f,
                                 "value": kv.tuple_(k, v), "process": 2})
        finally:
            c.teardown({})
        return CP.recorded(servers), done, c._port_ix


@pytest.mark.parametrize("op_name", list(REGISTER_OPS))
@pytest.mark.parametrize("scenario", REGISTER_SCENARIOS)
def test_sql_register_statements_and_completion(scenario, op_name):
    got = _register_once(TSQL, TKV, scenario, op_name)
    want = _register_once(JSQL, JKV, scenario, op_name)
    assert got[0] == want[0]
    assert P.plain(got[1]) == P.plain(want[1])
    assert got[2] == want[2]


G2_SCENARIOS = ["ok", "rows", "already-open", "commit-fail",
                "commit-unknown", "commit-lost"]


def _g2_once(S, scenario, value):
    state = {}
    with CP.LineServer(_sql_responder(scenario, 0, state)) as s:
        c = S.SqlG2Client([s.port], timeout_s=TIMEOUT).setup({}, None)
        c._session = SESSION
        state["armed"] = True
        try:
            done = c.invoke({}, {"type": "invoke", "f": "insert",
                                 "value": value, "process": 4})
        finally:
            c.teardown({})
        return CP.recorded([s]), done


@pytest.mark.parametrize("value", [(9, (21, None)), (9, (None, 22))])
@pytest.mark.parametrize("scenario", G2_SCENARIOS)
def test_sql_g2_statements_and_completion(scenario, value):
    got = _g2_once(TSQL, scenario, value)
    want = _g2_once(JSQL, scenario, value)
    assert got[0] == want[0]
    assert P.plain(got[1]) == P.plain(want[1])


def _sqltxn_once(S, T, scenario):
    state = {"armed": True}
    out = []
    with CP.LineServer(_sql_responder(scenario, 0, state)) as s:
        conn = CP.connect(T.SutConnection, s.port, timeout=TIMEOUT)
        t = S.SqlTxn(conn)
        for verb, args in (("begin", ()), ("read", (3,)),
                           ("predicate", ("b", 3)), ("write", (3, 4)),
                           ("insert", ("a", 3, 17, 30)),
                           ("commit", (99,)), ("abort", ())):
            try:
                out.append((verb, getattr(t, verb)(*args)))
            except (T.TxnAborted, TimeoutError) as e:
                out.append((verb, type(e).__name__, str(e)))
        conn.close()
        return CP.recorded([s]), out


@pytest.mark.parametrize("scenario", ["ok", "rows", "already-open",
                                      "commit-fail", "commit-lost",
                                      "cnonce-refused", "nil"])
def test_sql_txn_statements_equal_the_references(scenario):
    assert _sqltxn_once(TSQL, TT, scenario) == \
        _sqltxn_once(JSQL, JT, scenario)


# --- against a live node -------------------------------------------------------

@CP.needs_sut_node
def test_sql_statement_grammar():
    """Every statement shape the reference tests issue, round-tripped
    through one node by the port's connection."""
    with CP.cluster(TT.spawn_cluster, 1, durable=True,
                    timeout_ms=800) as (ports, _):
        c = CP.connect(TT.SutConnection, ports[0])
        try:
            for stmt in TSQL.SESSION_SETS:
                assert c.request(stmt) == "OK"
            assert c.request("SET hasql ON") == "OK"
            assert c.request(
                "insert into register (id, val) values (1, 5)") == "ROWS 1"
            assert c.request(
                "select val from register where id = 1") == "V 5"
            assert c.request(
                "select val from register where id = 9") == "NIL"
            assert c.request("update register set val = 7 "
                             "where id = 1 and val = 5") == "ROWS 1"
            assert c.request("update register set val = 9 "
                             "where id = 1 and val = 5") == "ROWS 0"
            t = TSQL.SqlTxn(c)
            t.begin()
            assert t.read(1) == 7
            t.write(1, 3)
            assert t.commit() == "ok"
            assert c.request(
                "select val from register where id = 1") == "V 3"
            assert c.request("begin") == "OK"
            assert c.request("update register set val = 4 "
                             "where id = 1 and val = 99") == "ROWS 0"
            assert c.request("commit").startswith("OK")
            assert c.request(
                "insert into jepsen (value) values (42)") == "ROWS 1"
            assert c.request(
                "insert into jepsen (value) values (43)") == "ROWS 1"
            assert c.request("select value from jepsen") == "V 42 43"
            assert c.request("select id, v from a where k = 2"
                             ).startswith("ERR")
            t = TSQL.SqlTxn(c)
            t.begin()
            assert t.predicate("a", 2) == []
            t.insert("a", 2, 100, 30)
            assert t.commit() == "ok"
            t = TSQL.SqlTxn(c)
            t.begin()
            assert t.predicate("a", 2) == [(100, 30)]
            t.abort()
            assert c.request("set cnonce 12345") == "OK"
            assert c.request(
                "insert into jepsen (value) values (77)") == "ROWS 1"
            assert c.request("set cnonce 12345") == "OK"
            assert c.request(
                "insert into jepsen (value) values (77)") == "ROWS 1"
            assert c.request("select value from jepsen") == "V 42 43 77"
            assert c.request("select val from nowhere").startswith("ERR")
            assert c.request("delete from register").startswith("ERR")
            assert c.request("update register set val = 9 "
                             "where id = 1 or val = 3").startswith("ERR")
            assert c.request("update register set val = 9 "
                             "where id = 1 and garbage").startswith("ERR")
            assert c.request("select val from register "
                             "where id = 1 or id = 2").startswith("ERR")
            assert c.request("select val from register "
                             "where id = 1") == "V 3"
            assert c.request("select value from jepsen "
                             "order by value") == "V 42 43 77"
            assert c.request("set transaction read committed") == "OK"
            assert c.request("set transaction serialzable").startswith(
                "ERR")
            assert c.request("set transaction serializable") == "OK"
        finally:
            c.close()


@CP.needs_sut_node
def test_ct_sql_shell():
    """The ``ct_sql`` mini-shell against a node the port spawned."""
    if not os.path.exists(CP.CT_SQL):
        pytest.skip("ct_sql not built")
    with CP.cluster(TT.spawn_cluster, 1, durable=True,
                    timeout_ms=800) as (ports, _):
        target = f"127.0.0.1:{ports[0]}"
        out = subprocess.run(
            [CP.CT_SQL, target, "-c", "set hasql on",
             "-c", "insert into register (id, val) values (3, 8)",
             "-c", "select val from register where id = 3"],
            capture_output=True, text=True, timeout=10)
        assert out.returncode == 0, out
        assert out.stdout.splitlines() == ["OK", "ROWS 1", "V 8"]
        bad = subprocess.run([CP.CT_SQL, target, "-c", "select nonsense"],
                             capture_output=True, text=True, timeout=10)
        assert bad.returncode == 1
        assert bad.stdout.startswith("ERR")


N_KEYS = 4


def _keyed_gen(seed):
    rngs = {}

    def op(test=None, process=None):
        rng = rngs.get(process)
        if rng is None:
            rng = rngs[process] = random.Random(f"{seed}/{process}")
        k = rng.randrange(N_KEYS)
        f = rng.choice(["read", "write", "cas", "cas"])
        if f == "read":
            return {"type": "invoke", "f": "read",
                    "value": TKV.tuple_(k, None)}
        if f == "write":
            return {"type": "invoke", "f": "write",
                    "value": TKV.tuple_(k, rng.randrange(5))}
        return {"type": "invoke", "f": "cas",
                "value": TKV.tuple_(k, (rng.randrange(5),
                                        rng.randrange(5)))}
    return op


@CP.needs_sut_node
def test_sql_register_workload_valid(tmp_path):
    """The register workload as SQL text over a 3-node cluster with a
    partition window stays linearizable, through both packages."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=300,
                    elect_ms=500, lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        t = TFAKE.noop_test(device="cpu")
        t.update({
            "nodes": [], "concurrency": 5, "name": "sql-register",
            "store-root": str(tmp_path / "store"),
            "client": TSQL.SqlClusterRegisterClient(ports, timeout_s=0.45),
            "model": TM.cas_register(),
            "nemesis": TT.ClusterPartitioner(ctl, isolate_primary=True),
            "generator": TG.nemesis(
                TG.seq([TG.sleep(0.3), {"type": "info", "f": "start"},
                        TG.sleep(1.0), {"type": "info", "f": "stop"}]),
                TG.time_limit(2.5, TG.stagger(0.01, _keyed_gen(5)))),
            "checker": TI.checker(TC.Linearizable(backend="host",
                                                  device="cpu")),
        })
        try:
            result = TCORE.run(t)
        finally:
            ctl.heal()
    want = JI.checker(JC.Linearizable(backend="host")).check(
        {"name": "jax", "dir": str(tmp_path / "jax")}, jcas_register(),
        P.to_jax(result["history"]))
    assert P.plain(result["results"]) == P.plain(want)
    assert result["results"]["valid?"] is True, result["results"]
    assert len([op for op in result["history"] if op.type == "ok"]) >= 40


@CP.needs_sut_node
def test_sql_g2_workload_valid(tmp_path):
    """G2 as SQL text: at most one insert commits per key."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True,
                    timeout_ms=500) as (ports, _):
        t = TFAKE.noop_test(device="cpu")
        t.update({
            "nodes": [], "concurrency": 6, "name": "sql-g2",
            "store-root": str(tmp_path / "store"),
            "client": TSQL.SqlG2Client(ports, timeout_s=0.6),
            "model": None,
            "generator": TG.clients(TG.time_limit(2.5, TW.g2_gen())),
            "checker": g2_checker,
        })
        result = TCORE.run(t)
    res = result["results"]
    assert P.plain(res) == P.plain(jg2_checker.check(
        None, None, P.to_jax(result["history"])))
    assert res["valid?"] is True, res
    assert res["legal-count"] >= 5, res


@CP.needs_sut_node
def test_sql_g2_buggy_txn_control_detected():
    """``-T`` through the SQL surface: two sessions predicate-read empty
    and both insert and commit; both packages' G2 checkers flag it."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=800,
                    flags=["-T"]) as (ports, _):
        c1 = CP.connect(TT.SutConnection, ports[0])
        c2 = CP.connect(TT.SutConnection, ports[1])
        try:
            for c in (c1, c2):
                assert c.request("set hasql on") == "OK"
                assert c.request("begin") == "OK"
                assert c.request("select id, v from a where k = 7") == "V"
                assert c.request("select id, v from b where k = 7") == "V"
            assert c1.request(
                "insert into a (id, k, v) values (1, 7, 30)") == "ROWS 1"
            assert c2.request(
                "insert into b (id, k, v) values (2, 7, 30)") == "ROWS 1"
            r1, r2 = c1.request("commit"), c2.request("commit")
        finally:
            c1.close()
            c2.close()
    assert r1.startswith("OK") and r2.startswith("OK"), (r1, r2)
    h = [Op(process=0, type="ok", f="insert", value=TKV.tuple_(7, (1, None))),
         Op(process=1, type="ok", f="insert",
            value=TKV.tuple_(7, (None, 2)))]
    res = g2_checker.check({}, None, h, {})
    assert P.plain(res) == P.plain(jg2_checker.check({}, None,
                                                     P.to_jax(h), {}))
    assert res["valid?"] is False, res
