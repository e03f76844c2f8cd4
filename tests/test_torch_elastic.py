"""The port's elastic fleet against the JAX package's, on CPU: ring
epochs, session checkpoint / restore / migration, drain, the routed
client's failure policy and the supervisor's lifecycle — one counterpart
for each test of ``tests/test_elastic.py``, each held to the JAX
package's answer on the same input.

Parity is exact unless a test says otherwise: ring owners and ring
positions, wire bytes, restored carries (seg2 frontiers as sets of
valid configs; the kernel rung's words after
``convert.session_checkpoint`` carries the JAX package's layout over),
verdicts, fail indices, final counts on VALID, replays and the
supervisor's policy. The port's kernel rung runs its plain version,
``seg_kernel.seg_search_reference``, on CPU tensors; the JAX package's
runs in Pallas interpret mode. Counters are compared, never wall time.
"""

import json
import os
import random
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.checker.batch import check_batch as j_check_batch
from comdb2_tpu.checker.batch import pack_batch as j_pack_batch
from comdb2_tpu.models.memo import IncrementalMemo as JMemo
from comdb2_tpu.models.memo import MemoOverflow as JMemoOverflow
from comdb2_tpu.models.model import MODELS as JMODELS
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JSY
from comdb2_tpu.ops.history import history_to_edn as j_edn
from comdb2_tpu.ops.packed import pack_history as j_pack
from comdb2_tpu.service import client as JCL
from comdb2_tpu.service import daemon as JD
from comdb2_tpu.service import supervisor as JSUP
from comdb2_tpu.service.core import VerifierCore as JCore
from comdb2_tpu.stream import checkpoint as JCK
from comdb2_tpu.stream.session import StreamSession as JSession

from comdb2_tpu_torch import convert
from comdb2_tpu_torch.models.memo import IncrementalMemo as TMemo
from comdb2_tpu_torch.models.memo import MemoOverflow as TMemoOverflow
from comdb2_tpu_torch.models.model import MODELS as TMODELS
from comdb2_tpu_torch.obs import trace as obs
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TSY
from comdb2_tpu_torch.ops.history import history_to_edn as t_edn
from comdb2_tpu_torch.service import client as TCL
from comdb2_tpu_torch.service import daemon as TD
from comdb2_tpu_torch.service import supervisor as TSUP
from comdb2_tpu_torch.service.core import VerifierCore as TCore
from comdb2_tpu_torch.stream import checkpoint as TCK
from comdb2_tpu_torch.stream.session import StreamSession as TSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch ops here are tiny; one intra-op thread keeps them
    off a busy host's thread pool. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_kernel():
    PS.use_interpret(True)
    PS.available.cache_clear()
    yield
    PS.use_interpret(False)
    PS.available.cache_clear()


def _feed(s, h, lo, hi, step=9):
    i = lo
    while i < hi:
        s.append(h[i:min(i + step, hi)])
        i += step


def _oneshot(h, model="cas-register", F=1024):
    """The JAX package's one-shot ``check_batch`` verdict."""
    b = j_pack_batch([j_pack(list(h))], JMODELS[model]())
    st, fa, nf = j_check_batch(b, F=F)
    return int(st[0]), int(fa[0]), int(nf[0])


def _both(make):
    """``make(synth, op)`` with each package's generator and op module:
    the same seeded history in each package's classes."""
    return make(JSY, JO), make(TSY, TO)


def _port(engine="auto"):
    return TSession("cas-register", engine=engine, device="cpu")


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _seg_configs(carry, P):
    st, sl, va = (_np(x) for x in carry[:3])
    return {(int(st[i]), tuple(int(x) for x in sl[i][:P]))
            for i in np.flatnonzero(va)}


def _t_roundtrip(s):
    """checkpoint -> wire -> restore in the port; returns (in-process
    ck, restored session)."""
    ck = s.checkpoint()
    wire = TCK.to_wire(ck)
    assert TCK.wire_nbytes(wire) > 0
    return ck, TSession.restore(TCK.from_wire(wire), device="cpu")


def _j_roundtrip(s):
    ck = s.checkpoint()
    return ck, JSession.restore(JCK.from_wire(JCK.to_wire(ck)))


# --- ring epochs -------------------------------------------------------------

def test_hash_ring_join_remaps_about_one_over_n():
    """A join remaps about 1/(N+1) of the keys, every moved key onto the
    newcomer, and every owner is the JAX package's ring's owner."""
    nodes = [f"sut/verifier/{i}" for i in range(4)]
    keys = [f"check|cas-register|{1 << (i % 12)}|{i}" for i in range(512)]
    before, after = TCL.HashRing(nodes), TCL.HashRing(
        nodes + ["sut/verifier/4"])
    jb, ja = JCL.HashRing(nodes), JCL.HashRing(nodes + ["sut/verifier/4"])
    assert [before.nodes_for(k) for k in keys] == \
        [jb.nodes_for(k) for k in keys]
    assert [after.nodes_for(k) for k in keys] == \
        [ja.nodes_for(k) for k in keys]
    moved = [k for k in keys
             if before.nodes_for(k)[0] != after.nodes_for(k)[0]]
    assert 0.02 < len(moved) / len(keys) < 0.45, len(moved)
    assert all(after.nodes_for(k)[0] == "sut/verifier/4" for k in moved)


def test_hash_ring_positions_are_the_reference_bytes():
    """``_hash64`` and the ring's points are the JAX package's byte for
    byte — str and bytes keys, non-ASCII names, every replica count the
    fleet uses — and ``route_key`` gives the same key for the same
    payload, so a key lands on the same daemon whichever package's
    client routes it."""
    rng = random.Random(7)
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
             for _ in range(300)]
    assert [TCL._hash64(b) for b in blobs] == \
        [JCL._hash64(b) for b in blobs]
    for nodes in (["sut/verifier/0"],
                  [f"sut/verifier/{i}" for i in range(7)],
                  ["a", "ü/verifier/1", "sut/verifier.epoch/x"]):
        for replicas in (1, 8, 64):
            t, j = TCL.HashRing(nodes, replicas), JCL.HashRing(nodes,
                                                               replicas)
            assert t._points == j._points and t.nodes == j.nodes
            keys = ["", "k", "ключ"] + blobs[:50]
            assert [t.nodes_for(k) for k in keys] == \
                [j.nodes_for(k) for k in keys]
    h = JSY.register_history(random.Random(3), 3, 40, p_info=0.0)
    text = j_edn(h)
    for route in ("shape", "payload"):
        for kind, model in (("check", None), ("wl", "bank"),
                            ("txn", "cas-register")):
            assert TCL.RoutedClient.route_key(text, kind, model, route) \
                == JCL.RoutedClient.route_key(text, kind, model, route)


def test_epoch_service_name_is_not_a_daemon_endpoint():
    prefix = "sut/verifier"
    for svc in (prefix, f"{prefix}/0", f"{prefix}/17"):
        assert TD.epoch_service_for(svc) == "sut/verifier.epoch" == \
            JD.epoch_service_for(svc)
    e = TD.epoch_service_for(prefix)
    assert e != prefix and not e.startswith(prefix + "/")
    assert TD.PMUX_SERVICE == JD.PMUX_SERVICE


# --- checkpoint/restore bit parity per rung ----------------------------------

def test_checkpoint_restore_bit_parity_xla():
    hj, ht = _both(lambda S, O: S.register_history(
        random.Random(4), n_procs=3, n_events=120, values=2, p_info=0.0,
        max_pending=2))
    s, sj = _port("xla"), JSession("cas-register", engine="xla")
    _feed(s, ht, 0, len(ht) // 2)
    _feed(sj, hj, 0, len(hj) // 2)
    ck, r = _t_roundtrip(s)
    _, rj = _j_roundtrip(sj)
    assert r._rung == rj._rung == "xla"
    for i, (a, b) in enumerate(zip(ck["eng"]["carry"], r._eng.carry)):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"carry[{i}]")
    # the restored carry holds the JAX package's restored frontier
    assert _seg_configs(r._eng.carry, r.P2) == \
        _seg_configs(rj._eng.carry, r.P2)
    assert r.memo.n_states == s.memo.n_states == rj.memo.n_states
    np.testing.assert_array_equal(r.memo.succ, s.memo.succ)
    np.testing.assert_array_equal(r.memo.succ, rj.memo.succ)
    assert r.seg.n_segments == s.seg.n_segments == rj.seg.n_segments
    assert r.seg.p_eff == s.seg.p_eff == rj.seg.p_eff
    np.testing.assert_array_equal(r.seg.inv_slot.a, s.seg.inv_slot.a)
    np.testing.assert_array_equal(r.seg.ok_slot.a, rj.seg.ok_slot.a)


def test_checkpoint_restore_bit_parity_mxu():
    h = TSY.pinned_wide_history(18)
    hj = JSY.pinned_wide_history(18)
    s = _port()
    _feed(s, h, 0, len(h), step=23)
    assert s._rung == "mxu"
    ck, r = _t_roundtrip(s)
    assert r._rung == "mxu"
    cw, rw = ck["eng"]["carry"], r._eng.carry
    for i, (a, b) in enumerate(zip(cw[0], rw[0])):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"words[{i}]")
    for i in range(1, 5):
        np.testing.assert_array_equal(_np(cw[i]), _np(rw[i]))
    # the JAX package's session, fed the same deltas, checkpoints the
    # same MXU carry through its own wire form
    sj = JSession("cas-register", engine="mxu")
    _feed(sj, hj, 0, len(hj), step=23)
    _, rj = _j_roundtrip(sj)
    jw = rj._eng.carry
    valid = _np(rw[1]).astype(bool)
    np.testing.assert_array_equal(valid, _np(jw[1]).astype(bool))
    for i, (a, b) in enumerate(zip(rw[0], jw[0])):
        np.testing.assert_array_equal(_np(a)[valid], _np(b)[valid],
                                      err_msg=f"reference words[{i}]")
    for i in range(2, 5):
        assert int(_np(rw[i]).reshape(-1)[0]) == \
            int(_np(jw[i]).reshape(-1)[0]), i
    out = r.finalize_input()
    exp = _oneshot(hj)
    assert (out["valid"] is True) == (exp[0] == 0)
    assert out["final_count"] == exp[2]


_H1 = [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
       ("invoke", 1, "write", 2), ("ok", 1, "write", 2),
       ("invoke", 0, "read", None), ("ok", 0, "read", 2)]
_H3 = [("invoke", 0, "read", None), ("ok", 0, "read", 1)]   # stale


def _ops(O, rows):
    return [getattr(O, t)(p, f, v) for t, p, f, v in rows]


def test_checkpoint_restore_bit_parity_kernel(interpret_kernel):
    """The kernel rung's (ws, stat) carry round-trips exactly through
    the wire form, and equals the JAX package's restored carry (its
    layout carried over by ``convert.session_checkpoint``)."""
    s, sj = _port(), JSession("cas-register")
    s.append(_ops(TO, _H1))
    sj.append(_ops(JO, _H1))
    assert s._rung == sj._rung == "kernel"
    ck, r = _t_roundtrip(s)
    assert r._rung == "kernel" and r._eng.spec == s._eng.spec
    np.testing.assert_array_equal(ck["eng"]["ws"], _np(r._eng.ws))
    np.testing.assert_array_equal(ck["eng"]["stat"], _np(r._eng.stat))
    ckj, _ = _j_roundtrip(sj)
    moved = convert.session_checkpoint(JCK.to_wire(ckj), "cpu")
    assert torch.equal(moved["eng"]["ws"], r._eng.ws)
    assert torch.equal(moved["eng"]["stat"][:3], r._eng.stat[:3])
    # the restored session catches the violation the live one would
    out = r.append(_ops(TO, _H3))
    assert out["valid"] is False and r.replays == 0
    outj = sj.append(_ops(JO, _H3))
    assert outj["valid"] is False and out["op_index"] == outj["op_index"]


_RESTORE_ELSEWHERE = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from comdb2_tpu_torch.ops import op as O
    from comdb2_tpu_torch.stream import checkpoint as CK
    from comdb2_tpu_torch.stream.session import StreamSession
    with open(sys.argv[1]) as fh:
        wire = json.load(fh)
    r = StreamSession.restore(CK.from_wire(wire), device="cpu")
    words, stat = r._eng.ws.tolist(), r._eng.stat.tolist()[:3]
    out = r.append([O.invoke(0, "read", None), O.ok(0, "read", 9)])
    print(json.dumps({"rung": r._rung, "words": words,
                      "stat": stat,
                      "valid": out["valid"], "op_index": out["op_index"],
                      "replays": r.replays,
                      "leaked": sorted(m for m in sys.modules
                                       if m == "jax" or m.startswith(
                                           ("jax.", "comdb2_tpu.")))}))
""")


def test_kernel_checkpoint_restores_in_another_process(tmp_path):
    """The JAX package's kernel-rung checkpoint, restored where its
    fused kernel cannot run, replays onto xla (``replays`` 1). The
    port's kernel rung has its plain version wherever it runs, so its
    checkpoint restores in ANOTHER process on the kernel rung with the
    same words and no replay (the card's daemon does the same on the
    card); both catch the same violation."""
    rows = [("invoke", 0, "write", 1), ("ok", 0, "write", 1),
            ("invoke", 1, "read", None), ("ok", 1, "read", 1)]
    s = _port()
    s.append(_ops(TO, rows))
    assert s._rung == "kernel"
    path = tmp_path / "ck.json"
    path.write_text(json.dumps(TCK.to_wire(s.checkpoint())))
    r = subprocess.run([sys.executable, "-c", _RESTORE_ELSEWHERE,
                        str(path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert got["rung"] == "kernel" and got["replays"] == 0
    assert got["words"] == s._eng.ws.tolist()
    assert got["stat"] == s._eng.stat.tolist()[:3]
    PS.use_interpret(True)
    PS.available.cache_clear()
    try:
        sj = JSession("cas-register")
        sj.append(_ops(JO, rows))
        assert sj._rung == "kernel"
        ckj = JCK.to_wire(sj.checkpoint())
    finally:
        PS.use_interpret(False)
        PS.available.cache_clear()
    rj = JSession.restore(JCK.from_wire(ckj))
    assert rj._rung in ("xla", "mxu") and rj.replays == 1
    outj = rj.append([JO.invoke(0, "read", None), JO.ok(0, "read", 9)])
    assert outj["valid"] is False is got["valid"]
    assert outj["op_index"] == got["op_index"]


# --- migration parity + O(delta) ---------------------------------------------

def _migration_cases():
    out = []
    for name, make in (
            ("valid", lambda S, O: S.register_history(
                random.Random(41), n_procs=3, n_events=96, values=2,
                p_info=0.0, max_pending=2)),
            ("invalid-tail", lambda S, O: S.inject_anomaly(
                S.register_history(random.Random(42), n_procs=3,
                                   n_events=60), "stale-read")[0])):
        hj, ht = _both(make)
        out.append((name, list(hj), list(ht)))
    return out


MIGRATION = _migration_cases()


@pytest.mark.parametrize("rung", ["xla", "kernel"])
@pytest.mark.parametrize("name,hj,ht", MIGRATION,
                         ids=[m[0] for m in MIGRATION])
def test_migration_mid_session_verdict_parity(name, hj, ht, rung):
    """A session checkpointed mid-way and finished elsewhere ends with
    the verdict, fail index and count of the JAX package's session
    migrated the same way, with no replay and O(delta) dispatches."""
    twin = JSession("cas-register", engine="xla")
    _feed(twin, hj, 0, len(hj))
    exp = twin.finalize_input()
    cut = len(hj) // 2
    sj = JSession("cas-register", engine="xla")
    _feed(sj, hj, 0, cut)
    _, rj = _j_roundtrip(sj)
    _feed(rj, hj, cut, len(hj))
    outj = rj.finalize_input()
    assert outj["valid"] == exp["valid"] and outj["replays"] == 0
    s = _port(rung)
    _feed(s, ht, 0, cut)
    d_half = s.dispatches
    _, r = _t_roundtrip(s)
    _feed(r, ht, cut, len(ht))
    out = r.finalize_input()
    assert out["valid"] == outj["valid"], (name, outj, out)
    assert out["op_index"] == outj["op_index"]
    if outj["valid"] is True:
        assert out["final_count"] == outj["final_count"]
    assert out["engine"] == rung and out["replays"] == 0
    assert out["dispatches"] - d_half <= d_half + 2, out


# --- eviction-restore round trip through the service -------------------------

def _cores(**kw):
    return JCore(**kw), TCore(device="cpu", **kw)


def _same(a, b, keys):
    assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}, \
        (a, b)


def test_core_eviction_restore_round_trip():
    hj, ht = _both(lambda S, O: S.register_history(
        random.Random(8), n_procs=3, n_events=48, p_info=0.0,
        max_pending=2))
    cut = len(ht) // 2
    now = obs.monotonic()
    replies = []
    for core, h, edn in zip(_cores(batch_cap=8, session_idle_s=5.0),
                            (hj, ht), (j_edn, t_edn)):
        _, r = core.submit({"kind": "stream", "verb": "open", "id": 1},
                           now)
        sid = r["session"]
        core.submit({"kind": "stream", "verb": "append", "id": 2,
                     "session": sid, "history": edn(h[:cut])}, now)
        (_, rep), = core.tick(now)
        assert rep["valid"] is True
        core.pump(now + 6.0)             # idle TTL passes -> evict
        assert core.m["stream_evicted"] == 1
        assert len(core.sessions) == 0
        assert core.sessions.checkpoint_count() == 1
        core.submit({"kind": "stream", "verb": "append", "id": 3,
                     "session": sid, "history": edn(h[cut:])}, now + 7.0)
        (_, rep2), = core.tick(now + 7.0)
        assert rep2["valid"] is True and rep2["replays"] == 0, rep2
        assert core.sessions.restores == 1
        _, cl = core.submit({"kind": "stream", "verb": "close", "id": 4,
                             "session": sid}, now + 8.0)
        replies.append((rep, rep2, cl))
    exp = _oneshot(hj)
    (j1, j2, jc), (t1, t2, tc) = replies
    for a, b in ((j1, t1), (j2, t2)):
        _same(a, b, ("ok", "valid", "op_index", "checked_through",
                     "replays"))
    _same(jc, tc, ("ok", "valid", "op_index", "final_count"))
    assert exp[0] == 0 and tc["valid"] is True and tc["final_count"] == exp[2]


def test_checkpoint_of_evicted_session_serves_held_snapshot():
    """``verb:"checkpoint"`` on an idle-evicted session serves the held
    host snapshot (no restore); ``release`` completes the move, and the
    handed-off checkpoint restores on a fresh core with the reference's
    final verdict and count."""
    hj, ht = _both(lambda S, O: S.register_history(
        random.Random(9), n_procs=3, n_events=30, p_info=0.0,
        max_pending=2))
    core = TCore(batch_cap=8, session_idle_s=5.0, device="cpu")
    now = obs.monotonic()
    _, r = core.submit({"kind": "stream", "verb": "open", "id": 1}, now)
    sid = r["session"]
    core.submit({"kind": "stream", "verb": "append", "id": 2,
                 "session": sid, "history": t_edn(ht)}, now)
    core.tick(now)
    core.pump(now + 6.0)
    assert core.sessions.checkpoint_count() == 1
    _, ckr = core.submit({"kind": "stream", "verb": "checkpoint", "id": 3,
                          "session": sid, "release": True}, now + 7.0)
    assert ckr["ok"] and ckr["released"], ckr
    assert core.sessions.restores == 0
    assert core.sessions.checkpoint_count() == 0
    core2 = TCore(batch_cap=8, device="cpu")
    _, mo = core2.submit({"kind": "stream", "verb": "open", "id": 4,
                          "checkpoint": ckr["checkpoint"]}, now + 8.0)
    assert mo["ok"] and mo["migrated"], mo
    _, cl = core2.submit({"kind": "stream", "verb": "close", "id": 5,
                          "session": mo["session"]}, now + 9.0)
    exp = _oneshot(hj)
    assert exp[0] == 0 and cl["valid"] is True
    assert cl["final_count"] == exp[2]


# --- drain -------------------------------------------------------------------

def test_drain_finalizes_staged_and_reroutes_forming():
    """Under drain, in both packages alike: staged requests finalize
    with real verdicts, forming ones answer shutting-down, new work
    sheds, the metrics scrape answers."""
    now = obs.monotonic()
    seen = []
    for core, S, edn in zip(_cores(batch_cap=2, F=64), (JSY, TSY),
                            (j_edn, t_edn)):
        def sub(i, n_events, seed):
            h = S.register_history(random.Random(seed), 3, n_events,
                                   p_info=0.0)
            return core.submit({"op": "check", "id": i,
                                "history": edn(h)}, now)

        _, r1 = sub(1, 24, 0)
        _, r2 = sub(2, 24, 0)
        assert r1 is None and r2 is None
        assert core.inflight() == 1, "batch did not stage"
        _, r3 = sub(3, 180, 2)
        assert r3 is None and core.queue_depth() == 1
        _, dr = core.submit({"kind": "drain", "id": 99}, now)
        assert dr["ok"] and dr["draining"] and dr["flushed"] == 1
        replies = {rep.get("id"): rep for _, rep in core.pump(now)}
        assert replies[1]["ok"] and replies[1]["valid"] is True
        assert replies[2]["ok"] and replies[2]["valid"] is True
        assert replies[3]["ok"] is False
        assert replies[3]["error"] == "shutting-down"
        assert core.drained()
        _, shed = sub(4, 24, 3)
        assert shed["error"] == "shutting-down" and shed["draining"]
        _, m = core.submit({"kind": "metrics", "id": 5}, now)
        assert m is None or m["ok"]
        seen.append((dr, replies, shed))
    (jd, jr, js), (td, tr, ts) = seen
    _same(jd, td, ("ok", "draining", "flushed"))
    for i in (1, 2, 3):
        _same(jr[i], tr[i], ("ok", "valid", "op_index", "error"))
    _same(js, ts, ("ok", "error", "draining"))


def test_drain_serves_checkpoint_handoff():
    hj, ht = _both(lambda S, O: S.register_history(
        random.Random(9), n_procs=3, n_events=40, p_info=0.0,
        max_pending=2))
    core = TCore(batch_cap=8, device="cpu")
    now = obs.monotonic()
    _, r = core.submit({"kind": "stream", "verb": "open", "id": 1}, now)
    sid = r["session"]
    core.submit({"kind": "stream", "verb": "append", "id": 2,
                 "session": sid, "history": t_edn(ht)}, now)
    core.tick(now)
    core.submit({"kind": "drain", "id": 3}, now)
    _, shed = core.submit({"kind": "stream", "verb": "append", "id": 4,
                           "session": sid, "history": t_edn(ht)}, now)
    assert shed["error"] == "shutting-down"
    _, ckr = core.submit({"kind": "stream", "verb": "checkpoint", "id": 5,
                          "session": sid, "release": True}, now)
    assert ckr["ok"] and ckr["checkpoint_bytes"] > 0
    assert len(core.sessions) == 0 and core.drained()
    core2 = TCore(batch_cap=8, device="cpu")
    _, mo = core2.submit({"kind": "stream", "verb": "open", "id": 6,
                          "checkpoint": ckr["checkpoint"]}, now)
    assert mo["ok"] and mo["migrated"], mo
    assert core2.m["stream_migrations"] == 1
    pm = core2.metrics_reply()["prometheus"]
    for metric in ("ring_epoch", "stream_migrations", "checkpoint_bytes"):
        assert metric in pm, metric
    _, cl = core2.submit({"kind": "stream", "verb": "close", "id": 7,
                          "session": mo["session"]}, now)
    exp = _oneshot(hj)
    assert exp[0] == 0 and cl["valid"] is True
    assert cl["final_count"] == exp[2]


# --- routed-client failure policy --------------------------------------------

class _StubClient:
    def __init__(self, fail=None, error_cls=TCL.ServiceError):
        self.calls = 0
        self.fail = fail                   # None | OSError | reply
        self.error_cls = error_cls

    def check(self, history, **kw):
        self.calls += 1
        if isinstance(self.fail, Exception):
            raise self.fail
        if self.fail is not None:
            raise self.error_cls.from_reply(self.fail)
        return {"ok": True, "valid": True}

    def close(self):
        pass


def _two_node_routed(cl, a, b):
    return cl.RoutedClient({"sut/verifier/0": a, "sut/verifier/1": b})


def _key_owned_by(rc, owner):
    for i in range(256):
        key = f"k{i}"
        if rc.ring.nodes_for(key)[0] == owner:
            return key
    raise AssertionError("no key hashed to the node")


def test_blacklist_skips_dead_node_within_ttl():
    a, b = _StubClient(fail=OSError("down")), _StubClient()
    rc = _two_node_routed(TCL, a, b)
    rc.blacklist_ttl_s = 0.2
    key = _key_owned_by(rc, "sut/verifier/0")
    assert key == _key_owned_by(_two_node_routed(JCL, a, b),
                                "sut/verifier/0")
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 1 and rc.failovers == 1
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 1                    # not re-dialed within the TTL
    a.fail = None
    time.sleep(0.25)
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 2


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_failover_honors_retry_after_ms(pkg):
    """An overloaded owner parks for its own ``retry_after_ms`` hint and
    the request fails over, in the port as in the JAX package."""
    cl = TCL if pkg == "port" else JCL
    a = _StubClient(fail={"ok": False, "error": "overload",
                          "retry_after_ms": 150}, error_cls=cl.ServiceError)
    b = _StubClient(error_cls=cl.ServiceError)
    rc = _two_node_routed(cl, a, b)
    key = _key_owned_by(rc, "sut/verifier/0")
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 1 and b.calls == 1
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 1 and b.calls == 2
    time.sleep(0.16)
    a.fail = None
    assert rc._route(key, lambda c: c.check("h"))["ok"]
    assert a.calls == 2


def test_shutting_down_reply_fails_over():
    a = _StubClient(fail={"ok": False, "error": "shutting-down"})
    b = _StubClient()
    rc = _two_node_routed(TCL, a, b)
    key = _key_owned_by(rc, "sut/verifier/0")
    out = rc._route(key, lambda c: c.check("h"))
    assert out["ok"] and b.calls == 1
    assert rc.failovers == 1
    err = TCL.ServiceError.from_reply({"ok": False,
                                       "error": "shutting-down"})
    assert str(err) == str(JCL.ServiceError.from_reply(
        {"ok": False, "error": "shutting-down"}))


def test_refresh_parks_pinned_nodes_for_handoff(monkeypatch):
    """A refresh that drops a node with streams pinned to it parks the
    warm client (a draining daemon serves handoffs only over open
    connections); unpinning finally closes it."""
    a, b = _StubClient(), _StubClient()
    closed = []
    a.close = lambda: closed.append("a")
    a.port, b.port = 7000, 7001
    rc = _two_node_routed(TCL, a, b)
    rc._disco = ("127.0.0.1", 5105, "sut/verifier", {})

    class _FakePmux:
        def __init__(self, *args, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def used(self):
            return {"sut/verifier/1": 7001}

    import comdb2_tpu_torch.control.pmux as pmux_mod
    monkeypatch.setattr(pmux_mod, "PmuxClient", _FakePmux)
    rc._pin("sut/verifier/0")
    added, removed = rc.refresh()
    assert removed == ["sut/verifier/0"] and not closed
    assert rc._parting["sut/verifier/0"] is a
    assert "sut/verifier/0" not in rc.clients
    rs = TCL.RoutedStream.__new__(TCL.RoutedStream)
    rs.routed, rs.node = rc, "sut/verifier/0"
    assert rs._client() is a
    rc._unpin("sut/verifier/0")
    assert closed == ["a"] and not rc._parting


def test_memo_overflow_leaves_checkpoint_replayable():
    """An extend that overflows ``max_states`` is not logged, so the
    checkpoint restores — and its log is the JAX package's."""
    logs = []
    for Memo, Over, models in ((TMemo, TMemoOverflow, TMODELS),
                               (JMemo, JMemoOverflow, JMODELS)):
        inc = Memo(models["cas-register"](), max_states=4)
        inc.extend([("write", 1)], 1)
        n_ok = inc.n_states
        with pytest.raises(Over):
            inc.extend([("write", 2), ("write", 3), ("write", 4),
                        ("write", 5)], 4)
        ck = inc.checkpoint()
        restored = Memo.restore(models["cas-register"](), ck)
        assert restored.transitions == [("write", 1)]
        assert restored.n_states == n_ok
        logs.append(json.dumps(TCK.to_wire(ck)))
    assert logs[0] == logs[1]


# --- wire codec --------------------------------------------------------------

def test_checkpoint_wire_codec_roundtrip():
    doc = {
        "arr": np.arange(12, dtype=np.int32).reshape(3, 4),
        "flags": np.array([True, False]),
        "tup": (1, ("cas", (0, 1)), None),
        "table": [("write", 1), ("cas", (1, 2))],
        "intkeys": {3: 7, 9: 1},
        "nested": {"x": [np.int32(5), "s", 2.5]},
        "i64": np.array([-2**40, 3], dtype=np.int64),
        "empty": np.zeros((0, 4), np.int32),
    }
    wire = TCK.to_wire(doc)
    assert json.dumps(wire) == json.dumps(JCK.to_wire(doc))
    assert TCK.wire_nbytes(wire) == JCK.wire_nbytes(JCK.to_wire(doc))
    for back in (TCK.from_wire(wire), JCK.from_wire(wire),
                 TCK.from_wire(JCK.to_wire(doc))):
        np.testing.assert_array_equal(back["arr"], doc["arr"])
        assert back["arr"].dtype == np.int32
        np.testing.assert_array_equal(back["flags"], doc["flags"])
        assert back["tup"] == (1, ("cas", (0, 1)), None)
        assert back["table"] == [("write", 1), ("cas", (1, 2))]
        assert back["intkeys"] == {3: 7, 9: 1}
        assert back["nested"]["x"][0] == 5
        np.testing.assert_array_equal(back["i64"], doc["i64"])
        assert back["empty"].shape == (0, 4)


# --- supervisor --------------------------------------------------------------

def test_supervisor_policy_pure():
    """The reference test's cases, and the whole grid against the JAX
    package's ``desired_count``."""
    f = TSUP.desired_count
    assert f(1, 0, 0, 0) == 1
    assert f(1, 100, 10, 0) == 2
    assert f(4, 1000, 1, 0, max_daemons=4) == 4
    assert f(2, 0, 10, 0) == 1
    assert f(1, 0, 10, 0) == 1
    assert f(1, 0, 10, 48, max_sessions=64) == 2
    assert f(2, 0, 10, 60, max_sessions=64) == 2
    grid = [(n, d, r, s, kw)
            for n in (1, 2, 3, 4, 5)
            for d in (0.0, 0.5, 3.0, 100.0)
            for r in (0.0, 0.1, 2.0, 50.0)
            for s in (0, 20, 47, 48, 96, 200)
            for kw in ({}, {"min_daemons": 2, "max_daemons": 3},
                       {"max_sessions": 16, "up_backlog_s": 0.5})]
    for n, d, r, s, kw in grid:
        assert f(n, d, r, s, **kw) == JSUP.desired_count(n, d, r, s, **kw)


def _state(pid):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return None


def test_supervisor_spawn_retire_reap_no_zombies():
    """Spawn a real daemon (``--backend cpu``), scrape it, beat, retire
    it; the child is reaped, not a zombie."""
    sup = TSUP.Supervisor(pmux_port=None, min_daemons=1, max_daemons=2,
                          daemon_args=["--backend", "cpu", "--no-prime",
                                       "--frontier", "64"],
                          drain_grace_s=3.0)
    child = sup.spawn()
    pid = child.proc.pid
    try:
        stats = sup.scrape()
        assert stats and stats[0]["queue_depth"] == 0
        summary = sup.beat()
        assert summary["daemons"] == 1
    finally:
        sup.shutdown()
    assert child.proc.returncode is not None
    assert _state(pid) != "Z", "retired daemon left a zombie"
    assert sup.retired == 1 and len(sup.children) == 0
    child.proc.stdout.close()


def test_a_daemon_that_dies_before_ready_shows_its_stderr(tmp_path,
                                                          monkeypatch):
    """A daemon that cannot start (here ``--backend cuda`` with no card
    visible) fails the spawn with its own stderr in the error, not a
    bare "no ready line"; without ``stderr_dir`` the supervisor still
    discards it, as the JAX package's does."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    sup = TSUP.Supervisor(pmux_port=None, daemon_args=["--backend",
                                                       "cuda"],
                          stderr_dir=str(tmp_path / "err"),
                          spawn_timeout_s=120.0)
    with pytest.raises(OSError) as ei:
        sup.spawn()
    msg = str(ei.value)
    assert "CUDA is not available" in msg, msg
    assert os.path.exists(tmp_path / "err" / "daemon-0.err")
    assert not sup.children and sup.spawned == 0
    bare = TSUP.Supervisor(pmux_port=None, daemon_args=["--backend",
                                                        "cuda"],
                           spawn_timeout_s=120.0)
    assert bare.stderr_dir is None
    with pytest.raises(OSError) as ei:
        bare.spawn()
    assert "CUDA is not available" not in str(ei.value)


def test_a_daemon_killed_after_ready_is_reaped_with_its_stderr(
        tmp_path, caplog):
    """SIGKILL after the ready line: the beat reaps the corpse (no
    zombie), counts the death, refills the floor, and logs the dead
    daemon's stderr file with its exit."""
    sup = TSUP.Supervisor(pmux_port=None, min_daemons=1, max_daemons=1,
                          daemon_args=["--backend", "cpu", "--no-prime",
                                       "--frontier", "64"],
                          drain_grace_s=1.0, stderr_dir=str(tmp_path))
    victim = sup.spawn()
    try:
        assert victim.stderr_path == str(tmp_path / "daemon-0.err")
        with open(victim.stderr_path, "a") as fh:
            fh.write("a line the dead daemon wrote\n")
        victim.proc.kill()          # the beat reaps it, not this test
        deadline = time.monotonic() + 60
        with caplog.at_level("WARNING", logger=TSUP.__name__):
            while sup.deaths == 0 and time.monotonic() < deadline:
                sup.beat()
                time.sleep(0.05)
        assert sup.deaths == 1 and len(sup.children) == 1
        assert 0 not in sup.children
        assert "a line the dead daemon wrote" in caplog.text
        assert _state(victim.proc.pid) != "Z"
    finally:
        sup.shutdown()
        victim.proc.stdout.close()
    assert sup.retired == 1 and not sup.children
