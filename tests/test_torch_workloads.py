"""The port's comdb2 workloads (``comdb2_tpu_torch.workloads``:
``sqlish`` and ``comdb2``) against the JAX package's.

Each tester runs at ``device="cpu"`` through the port's
``core.run`` against the in-memory serializable backend (``MemDB``), as
``tests/test_workloads.py`` runs the JAX package's, with time limits of
at most 1.5 s. The recorded history then goes through the checker
composition the JAX package's tester makes: its results must equal the
port's (``torch_harness_parity.plain``: ops as plain tuples; the engine
labels dropped, which name the engine, not the verdict). ``MemDB``'s
serializability, rollback and chaos outcomes under one seed must be
equal too, and a tester given no device raises on a host without CUDA
before any worker runs.
"""

import pytest
import torch

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.harness import generator as JG
from comdb2_tpu.workloads import comdb2 as JW
from comdb2_tpu.workloads import sqlish as JSQ

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.harness import client as TCL
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.harness import nemesis as TN
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import sqlish as TSQ

import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)


def _small(test, tmp_path):
    test["store-root"] = str(tmp_path / "store")
    test["nodes"] = []
    return test


def _run_and_recheck(t, jax_test, tmp_path):
    """Run the port's test ``t``; check its history with the JAX
    package's test map's checker; return (port result, JAX results)."""
    r = TCORE.run(_small(t, tmp_path))
    want = jax_test["checker"].check(
        {"name": t["name"], "dir": str(tmp_path / "jax")},
        jax_test.get("model"), P.to_jax(r["history"]))
    assert P.plain(r["results"]) == P.plain(want)
    return r, want


def test_register_workload(tmp_path):
    t = TW.register_tester(time_limit=1.0, device="cpu")
    t["concurrency"] = 6
    r, _ = _run_and_recheck(t, JW.register_tester(time_limit=1.0),
                            tmp_path)
    assert r["results"]["valid?"] is True, r["results"]
    assert r["results"]["linearizable"]["valid?"] is True
    assert len(r["history"]) > 20


def test_register_workload_with_chaos(tmp_path):
    db = TSQ.MemDB(chaos_fail=0.1, chaos_unknown=0.05, seed=1)
    t = TW.register_tester(connect=db.connect, time_limit=1.5,
                           device="cpu")
    t["concurrency"] = 6
    r, _ = _run_and_recheck(t, JW.register_tester(time_limit=1.5),
                            tmp_path)
    # fails and indeterminates are normal; the history stays
    # linearizable because MemDB itself is correct
    assert r["results"]["valid?"] is True, r["results"]
    assert any(op.type == "info" for op in r["history"])
    assert any(op.type == "fail" for op in r["history"])


def test_bank_workload(tmp_path):
    t = TW.bank_test(time_limit=1.0, n=4, device="cpu")
    t["concurrency"] = 6
    r, _ = _run_and_recheck(t, JW.bank_test(time_limit=1.0, n=4), tmp_path)
    assert r["results"]["valid?"] is True, r["results"]
    reads = [op for op in r["history"]
             if op.type == "ok" and op.f == "read" and op.value]
    assert reads and all(sum(op.value) == 40 for op in reads)


def test_sets_workload(tmp_path):
    t = TW.sets_test(adds=40, device="cpu")
    t["concurrency"] = 5
    r, _ = _run_and_recheck(t, JW.sets_test(adds=40), tmp_path)
    assert r["results"]["valid?"] is True, r["results"]
    assert r["results"]["ok-frac"] == 1.0


def _lossy_conn(SQ):
    db = SQ.MemDB()
    db.counter = 0

    class LossyConn(SQ.MemConn):
        """Acks every 5th write txn but discards its buffered writes at
        commit: data loss the checker must catch."""

        def transaction(self):
            ctx = super().transaction()
            conn_db = self.db

            class MaybeDropCtx:
                def __enter__(s):
                    s.t = ctx.__enter__()
                    return s.t

                def __exit__(s, *a):
                    if a[0] is None and s.t.writes:
                        conn_db.counter += 1
                        if conn_db.counter % 5 == 0:
                            s.t.writes.clear()    # lost update
                    return ctx.__exit__(*a)
            return MaybeDropCtx()
    return lambda: LossyConn(db)


def test_sets_workload_lossy_backend_detected(tmp_path):
    t = TW.sets_test(connect=_lossy_conn(TSQ), adds=40, device="cpu")
    t["concurrency"] = 5
    r, _ = _run_and_recheck(t, JW.sets_test(adds=40), tmp_path)
    assert r["results"]["valid?"] is False
    assert r["results"]["lost"] != "#{}"


def test_dirty_reads_workload(tmp_path):
    t = TW.dirty_reads_tester(time_limit=0.5, n=3, device="cpu")
    r, _ = _run_and_recheck(t, JW.dirty_reads_tester(time_limit=0.5, n=3),
                            tmp_path)
    assert r["results"]["valid?"] is True, r["results"]


def test_g2_workload(tmp_path):
    t = TW.g2_test(ops=60, device="cpu")
    t["concurrency"] = 6
    r, _ = _run_and_recheck(t, JW.g2_test(ops=60), tmp_path)
    assert r["results"]["valid?"] is True, r["results"]
    assert r["results"]["key-count"] >= 1


class _BrokenG2Client(TCL.Client):
    """Predicate reads that miss concurrent inserts: every insert
    commits, so both of a key's inserts succeed."""

    def invoke(self, test, op):
        return {**op, "type": "ok"}


def test_g2_broken_backend_detected(tmp_path):
    t = TW.g2_test(ops=30, device="cpu")
    t["client"] = _BrokenG2Client()
    t["concurrency"] = 6
    r, _ = _run_and_recheck(t, JW.g2_test(ops=30), tmp_path)
    assert r["results"]["valid?"] is False
    assert r["results"]["illegal-count"] >= 1


def test_list_append_client_through_both_serializable_checkers(tmp_path):
    """The list-append client (no tester of its own) in a run checked
    by the port's and the JAX package's graph checker."""
    db = TSQ.MemDB()
    t = TW.basic_test({
        "name": "list-append", "concurrency": 4,
        "client": TW.ListAppendClient(db.connect),
        "generator": TG.clients(TG.limit(40, TW.list_append_gen(3, 3))),
        "checker": TC.Serializable(backend="host", device="cpu")},
        device="cpu")
    r = TCORE.run(_small(t, tmp_path))
    want = JC.Serializable(backend="host").check(
        {}, None, P.to_jax(r["history"]))
    assert P.plain(r["results"]) == P.plain(want)
    assert r["results"]["valid?"] is True


def test_register_nemesis_tester_shape():
    """The tester's map: name, nemesis, checker composition, model and
    keys as the JAX package's. Its generator wraps an endless client mix
    in the nemesis cycle, unbounded by ``time_limit`` in both packages."""
    t = TW.register_tester_nemesis(time_limit=1.0, device="cpu")
    j = JW.register_tester_nemesis(time_limit=1.0)
    assert t["name"] == j["name"] == "register-nemesis"
    assert isinstance(t["nemesis"], TN.Partitioner)
    assert sorted(t) == sorted(j)
    assert sorted(t["checker"].checker_map) == \
        sorted(j["checker"].checker_map)
    assert t["model"].describe() == j["model"].describe()
    assert (t["concurrency"], t["nodes"]) == (j["concurrency"], j["nodes"])
    lin = t["checker"].checker_map["linearizable"]
    assert str(lin.base.device) == "cpu"


TESTERS = ["register_tester", "register_tester_nemesis", "bank_test",
            "sets_test", "dirty_reads_tester", "g2_test"]


@pytest.mark.parametrize("tester", TESTERS)
def test_default_device_raises_before_any_worker(tester, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    ran = []
    monkeypatch.setattr(TCORE, "run_case", lambda test: ran.append(test))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCORE.run(getattr(TW, tester)())
    assert ran == []


def _memdb_script(SQ, chaos):
    """One fixed sequence of autocommit and transactional ops on a
    seeded MemDB; returns each step's outcome and the final tables."""
    db = SQ.MemDB(**chaos, seed=9)
    c = db.connect()
    out = []

    def step(fn):
        try:
            out.append(("ok", fn()))
        except (SQ.Rollback, SQ.Indeterminate, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))

    for i in range(12):
        step(lambda i=i: c.insert("t", {"id": i, "v": i * 10}))
    step(lambda: c.update("t", {"v": -1}, lambda r: r["id"] % 3 == 0))
    step(lambda: c.delete("t", lambda r: r["id"] > 9))
    step(lambda: len(c.select("t")))

    def aborted():
        with c.transaction() as t:
            t.insert("t", {"id": 99})
            raise RuntimeError("abort")
    step(aborted)
    step(lambda: SQ.with_txn_retries(lambda: c.insert("u", {"id": 0})))
    step(lambda: [db.gen_key() for _ in range(3)])
    return out, {k: sorted(map(sorted, (r.items() for r in v)))
                 for k, v in db.tables.items()}


@pytest.mark.parametrize("chaos", [
    {}, {"chaos_fail": 1.0}, {"chaos_unknown": 1.0},
    {"chaos_fail": 0.3, "chaos_unknown": 0.3}])
def test_memdb_outcomes_equal(chaos):
    got = _memdb_script(TSQ, chaos)
    assert got == _memdb_script(JSQ, chaos)
    if not chaos:
        assert got[0][-4] == ("ok", 10)
        assert ("RuntimeError", "abort") in got[0]


def test_with_txn_retries_gives_up_with_the_last_error():
    for SQ in (TSQ, JSQ):
        db = SQ.MemDB(chaos_fail=1.0)
        with pytest.raises(SQ.Rollback):
            SQ.with_txn_retries(lambda: db.connect().insert("t", {}),
                                attempts=5)


def test_register_client_ops_equal_under_one_seed():
    """The cas-register client's completions for one seeded stream of
    [w cas cas r] ops, one worker, through each package's client."""
    import random

    out = []
    for W, SQ, G in ((TW, TSQ, TG), (JW, JSQ, JG)):
        random.seed(21)
        c = W.CasRegisterClient(SQ.MemDB().connect).setup({}, None)
        g = G.mix([W.w, W.cas, W.cas, W.r])
        ops = []
        for _ in range(60):
            o = c.invoke({}, G.op(g, {"concurrency": 1}, 0))
            v = o["value"]
            ops.append((o["type"], o["f"], tuple(v) if v else v))
        out.append(ops)
    assert out[0] == out[1]
    assert {t for t, _, _ in out[0]} == {"ok", "fail"}
