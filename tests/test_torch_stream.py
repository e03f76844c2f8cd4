"""The port's streaming sessions against the JAX package's, on CPU.

The same seeded histories (made by both packages' ``ops.synth`` from
one ``random.Random`` seed, or written out op by op) are appended in
the same deltas to a JAX-package session and to a port session on CPU
tensors. Parity is exact: verdicts, fail indices, final counts on
VALID, segment streams, id tables, memo state ids, dispatch counters
and checkpoint wire bytes. The JAX package's kernel rung runs through
``pallas_seg.use_interpret(True)``; the port's through the kernel's
plain version, ``seg_kernel.seg_search_reference``. Seg2 frontiers
are compared as sets of valid configs (rows past the valid prefix are
don't-care in both packages). Work is asserted on dispatch and
segment counters, never on wall time.
"""

import random

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.checker.batch import check_batch, pack_batch
from comdb2_tpu.checker.independent import wrap_keyed_history as jwrap
from comdb2_tpu.models.memo import IncrementalMemo as JMemo
from comdb2_tpu.models.model import MODELS as JMODELS
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JSY
from comdb2_tpu.ops.packed import pack_history as jpack
from comdb2_tpu.stream import StreamIngest as JIngest
from comdb2_tpu.stream import StreamSession as JSession
from comdb2_tpu.stream import checkpoint as JCK
from comdb2_tpu.stream import engine as JE

from comdb2_tpu_torch import convert
from comdb2_tpu_torch import filetest as TF
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models.memo import IncrementalMemo as TMemo
from comdb2_tpu_torch.models.model import MODELS as TMODELS
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TSY
from comdb2_tpu_torch.ops.history import history_to_edn
from comdb2_tpu_torch.ops.kv import wrap_keyed_history as twrap
from comdb2_tpu_torch.ops.packed import pack_history as tpack
from comdb2_tpu_torch.stream import (MalformedDelta, SessionLimit,
                                     SessionManager, StreamIngest,
                                     StreamSession)
from comdb2_tpu_torch.stream import checkpoint as TCK
from comdb2_tpu_torch.stream import engine as TE

V = {True: 0, False: 1, "unknown": 2}
ARRAYS = ("process", "type", "f", "value", "trans", "pair", "fails",
          "time")
TABLES = ("process_table", "f_table", "value_table",
          "transition_table")


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
    PS.available.cache_clear()      # pick_rung probes through it
    yield
    PS.use_interpret(False)
    PS.available.cache_clear()


def _port_ops(h):
    return [TO.Op(o.process, o.type, o.f, o.value, index=o.index,
                  time=o.time) for o in h]


def _keyed(pkg_op, rng, n=24):
    h = []
    for _ in range(n):
        k, p, v = rng.randrange(3), rng.randrange(4), rng.randrange(3)
        h.append(pkg_op.invoke(p, "write", (k, v)))
        h.append(pkg_op.ok(p, "write", (k, v)))
    return h


def _families():
    """(name, model, JAX-package history, port history) per family,
    each pair built from one seed by each package's own generator."""
    out = []
    for pkg, op, wrap in ((JSY, JO, jwrap), (TSY, TO, twrap)):
        rng = random.Random(1311)
        hs = [pkg.register_history(rng, n_procs=4, n_events=60,
                                   p_info=0.05),
              pkg.register_history(rng, n_procs=6, n_events=60,
                                   values=3, max_pending=3),
              wrap(_keyed(op, rng)),
              pkg.inject_anomaly(pkg.register_history(
                  rng, n_procs=4, n_events=40), "stale-read")[0]]
        out.append(hs)
    names = [("register", "cas-register"), ("cas-bounded", "cas-register"),
             ("keyed", "cas-register-comdb2"),
             ("register-invalid", "cas-register")]
    return [(n, m, j, t) for (n, m), j, t in zip(names, *out)]


FAMILIES = _families()
FAMILY_IDS = [f[0] for f in FAMILIES]


def _oneshot(h, model, F=1024):
    b = pack_batch([jpack(list(h))], JMODELS[model]())
    st, fa, nf = check_batch(b, F=F)
    return int(st[0]), int(fa[0]), int(nf[0])


def _deltas(n, seed, max_delta):
    rng = random.Random(seed)
    cuts, i = [], 0
    while i < n:
        k = min(n - i, rng.randint(1, max_delta))
        cuts.append((i, i + k))
        i += k
    return cuts


def _feed(session, h, seed=3, max_delta=13):
    outs = [session.append(h[a:b])
            for a, b in _deltas(len(h), seed, max_delta)]
    return outs, session.finalize_input()


def _port(model="cas-register", **kw):
    return StreamSession(model, device="cpu", **kw)


def _verdict(out):
    return V[out["valid"]], out["op_index"], out["final_count"]


def _assert_verdict(exp, out):
    got = _verdict(out)
    assert exp[0] == got[0] and exp[1] == got[1], (exp, got)
    if exp[0] == 0:            # counts compare on VALID only
        assert exp[2] == got[2], (exp, got)


MAP_KEYS = ("valid", "op_index", "op_count", "checked_through",
            "segments", "engine", "appends", "replays")
#: the kernel rung re-encodes its carry on growth where the JAX package
#: replays, and launches once per delta where it launches per chunk:
#: ``replays`` and ``dispatches`` differ there by design
KERNEL_MAP_KEYS = MAP_KEYS[:-1]


def _same_map(j, t, keys=MAP_KEYS):
    assert {k: j.get(k) for k in keys} == {k: t.get(k) for k in keys}
    if j["valid"] is True:
        assert j["final_count"] == t["final_count"]


def _seg_configs(carry, P):
    st, sl, va = (np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                             else x) for x in carry[:3])
    return {(int(st[i]), tuple(int(x) for x in sl[i][:P]))
            for i in np.flatnonzero(va)}


# --- bit parity below the device layer --------------------------------------

@pytest.mark.parametrize("name,model,hj,ht", FAMILIES, ids=FAMILY_IDS)
def test_ingest_bit_parity(name, model, hj, ht):
    """The port's incremental pack settles the same columns and id
    tables as the JAX package's (and as the one-shot pack), delta by
    delta."""
    ij, it = JIngest(), StreamIngest()
    for a, b in _deltas(len(hj), 7, 9):
        assert ij.append(hj[a:b]) == it.append(ht[a:b])
        assert ij.settled == it.settled
    assert ij.finalize() == it.finalize()
    got, want, one = it.packed_history(), ij.packed_history(), \
        tpack(list(ht))
    for a in ARRAYS:
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a),
                                      err_msg=f"{name}.{a}")
        np.testing.assert_array_equal(getattr(got, a), getattr(one, a),
                                      err_msg=f"{name}.{a} one-shot")
    for t in TABLES:
        assert getattr(got, t) == getattr(want, t), f"{name}.{t}"
        assert getattr(got, t) == getattr(one, t), f"{name}.{t}"


@pytest.mark.parametrize("name,model,hj,ht", FAMILIES, ids=FAMILY_IDS)
def test_segment_bit_parity(name, model, hj, ht):
    """Incremental segmentation + carried slot renaming: the port's
    retained renamed stream, owner maps and P_eff equal the JAX
    package's, and the one-shot ``make_segments`` + ``remap_slots``."""
    sj, st = JSession(model, engine="xla"), _port(model, engine="xla")
    for a, b in _deltas(len(hj), 11, 9):
        sj.append(hj[a:b])
        st.append(ht[a:b])
    sj.finalize_input()
    st.finalize_input()
    cj, ct = sj.seg.checkpoint(), st.seg.checkpoint()
    assert cj.keys() == ct.keys()
    for k in cj:
        if isinstance(cj[k], np.ndarray):
            np.testing.assert_array_equal(cj[k], ct[k], err_msg=k)
            assert cj[k].dtype == ct[k].dtype, k
        else:
            assert cj[k] == ct[k], k
    packed = tpack(list(ht))
    segs = LT.make_segments(packed)
    renamed, p_eff = LT.remap_slots(segs)
    S = renamed.ok_proc.shape[0]
    assert st.seg.n_segments == S and st.seg.p_eff == p_eff
    K = max(renamed.inv_proc.shape[1], st.seg.k_max)
    ip, _, okp, dp = st.seg.padded(0, S, S, K)
    np.testing.assert_array_equal(
        ip, np.pad(renamed.inv_proc,
                   ((0, 0), (0, K - renamed.inv_proc.shape[1])),
                   constant_values=-1))
    np.testing.assert_array_equal(okp, renamed.ok_proc)
    np.testing.assert_array_equal(dp, renamed.depth)
    np.testing.assert_array_equal(st.seg.seg_row.a[:S], segs.seg_index)


MEMO_RUNS = [
    [(["write", 1], ["write", 2]), 1, (["read", 1], ["cas", (1, 2)]), 2,
     (["read", None], ["write", 3]), 5],
    [(["write", 1],), 3, (), 4, (["cas", (1, 2)], ["cas", (2, 1)]), 4],
    [(["read", 7],), 1, (["write", 7], ["read", None]), 6],
    [[("write", v) for v in range(6)], 2,
     [("cas", (v, v + 1)) for v in range(5)], 7],
]


@pytest.mark.parametrize("run", range(len(MEMO_RUNS)))
def test_incremental_memo_matches_the_jax_package(run):
    """Same extension sequence -> the same states in the same order,
    the same successor table and the same ``version`` steps; the
    checkpoint log replays to the identical memo."""
    steps = MEMO_RUNS[run]
    mj = JMemo(JMODELS["cas-register"]())
    mt = TMemo(TMODELS["cas-register"]())
    versions = []
    for tr, d in zip(steps[::2], steps[1::2]):
        tr = [tuple(t) for t in tr]
        mj.extend(tr, d)
        mt.extend(tr, d)
        versions.append((mj.version, mt.version))
        assert mj.n_states == mt.n_states
        np.testing.assert_array_equal(mj.succ, mt.succ)
    assert all(a == b for a, b in versions), versions
    assert [repr(s) for s in mj.states] == [repr(s) for s in mt.states]
    assert mj.checkpoint() == mt.checkpoint()
    back = TMemo.restore(TMODELS["cas-register"](), mj.checkpoint())
    np.testing.assert_array_equal(back.succ, mt.succ)
    assert back.version == len(back.checkpoint()["log"])


# --- verdict parity per rung -------------------------------------------------

@pytest.mark.parametrize("rung", ["xla", "mxu"])
@pytest.mark.parametrize("name,model,hj,ht", FAMILIES, ids=FAMILY_IDS)
def test_delta_verdict_parity_xla_mxu(name, model, hj, ht, rung):
    """Forced xla / mxu rung: the same verdict map, the same dispatch
    count (both rungs share ``DELTA_PADS``), and the one-shot
    verdict."""
    sj, st = JSession(model, engine=rung), _port(model, engine=rung)
    _, oj = _feed(sj, hj)
    _, ot = _feed(st, ht)
    _same_map(oj, ot)
    assert oj["dispatches"] == ot["dispatches"]
    assert oj.get("engines_tried") == ot.get("engines_tried")
    _assert_verdict(_oneshot(hj, model), ot)


@pytest.mark.parametrize("name,model,hj,ht", FAMILIES, ids=FAMILY_IDS)
def test_delta_verdict_parity_kernel(name, model, hj, ht):
    """The kernel rung (the port's plain version) against the one-shot
    check, one launch per delta."""
    st = _port(model, engine="kernel")
    for a, b in _deltas(len(ht), 3, 13):
        d0 = st.dispatches
        st.append(ht[a:b])
        assert st.dispatches - d0 <= 1          # one launch per delta
    ot = st.finalize_input()
    assert ot["replays"] == 0                   # growth re-encodes
    assert ot["engine"] == "kernel"
    _assert_verdict(_oneshot(hj, model), ot)


def test_kernel_rung_matches_the_interpreted_kernel(interpret_kernel):
    """The JAX package's kernel rung (interpret mode) and the port's,
    fed the same deltas: same verdicts after every append and the same
    decoded frontier at the end."""
    name, model, hj, ht = FAMILIES[1]
    hj, ht = hj[:48], ht[:48]
    sj, st = JSession(model, engine="kernel"), _port(model,
                                                     engine="kernel")
    for a, b in _deltas(len(hj), 3, 13):
        _same_map(sj.append(hj[a:b]), st.append(ht[a:b]),
                  KERNEL_MAP_KEYS)
    _same_map(sj.finalize_input(), st.finalize_input(), KERNEL_MAP_KEYS)
    assert st.replays == 0
    assert sj._eng.spec.n_words == st._eng.spec.n_words
    P = st.P2
    assert SK.decode_frontier(st._eng.spec, st._eng.ws, P) == \
        PS.decode_frontier(sj._eng.spec, [np.asarray(w)
                                          for w in sj._eng.ws], P)


def test_auto_takes_the_kernel_rung_on_cpu():
    """On CPU tensors ``auto`` picks the kernel rung (its plain
    version), where the JAX package on CPU without interpret mode
    picks xla: a rung difference, not a verdict difference."""
    name, model, hj, ht = FAMILIES[0]
    _, ot = _feed(_port(model), ht)
    _, oj = _feed(JSession(model), hj)
    assert ot["engine"] == "kernel" and oj["engine"] == "xla"
    _assert_verdict(_verdict(oj), ot)


def test_wide_p_parity_rides_mxu():
    """Concurrency growth re-routes the session to the MXU rung
    mid-stream (replay); the final verdict matches the JAX package's
    one-shot check."""
    hj, ht = JSY.pinned_wide_history(18), TSY.pinned_wide_history(18)
    _, ot = _feed(_port(), ht, seed=5, max_delta=23)
    _assert_verdict(_oneshot(hj, "cas-register"), ot)
    assert ot["engine"] == "mxu"
    assert ot["replays"] >= 1


def test_invalid_latches_without_dispatch():
    rng = random.Random(2)
    h, _ = TSY.inject_anomaly(TSY.register_history(rng, n_procs=3,
                                                   n_events=30),
                              "stale-read")
    s = _port()
    _, out = _feed(s, h, seed=2)
    assert out["valid"] is False
    d0, e0 = s.dispatches, TE.DISPATCHES
    r = s.append(h[:8])
    assert r["valid"] is False and r.get("latched")
    assert s.dispatches == d0 and TE.DISPATCHES == e0


def _burst():
    h = []
    for pkg in (JO, TO):
        x = [pkg.invoke(p, "write", p) for p in range(8)]
        x += [pkg.ok(p, "write", p) for p in range(8)]
        x += [pkg.invoke(0, "read", None), pkg.ok(0, "read", 7)]
        h.append(x)
    return h


def test_escalation_mid_session_resumes_in_place():
    """A concurrency burst overflows the first frontier rung: the
    pre-delta carry widens in place and only the delta re-runs — in
    both packages, to the same capacity and verdict."""
    hj, ht = _burst()
    exp = _oneshot(hj, "cas-register", F=8192)
    sj, st = JSession("cas-register", engine="xla"), _port(engine="xla")
    for s, h in ((sj, hj), (st, ht)):
        s.append(h[:9])
        s.append(h[9:])
    oj, ot = sj.finalize_input(), st.finalize_input()
    _assert_verdict(exp, ot)
    _same_map(oj, ot)
    assert ot["frontier_capacity"] == oj["frontier_capacity"] \
        > TE.STREAM_CAPACITIES[0]
    assert ot["replays"] == 0
    assert ot["dispatches"] == oj["dispatches"]
    assert _seg_configs(st._eng.carry, st.P2) == \
        _seg_configs(sj._eng.carry, sj.P2)


@pytest.mark.parametrize("rung", ["xla", "kernel"])
def test_per_append_work_is_o_delta(rung):
    """Every same-sized append costs at most one dispatch however long
    the session is, and the dispatched segments add up to the
    session's segments exactly once; on the xla rung the counts per
    append equal the JAX package's."""
    hj = JSY.register_history(random.Random(4), n_procs=3,
                              n_events=240, values=2, p_info=0.0,
                              max_pending=2)
    ht = TSY.register_history(random.Random(4), n_procs=3,
                              n_events=240, values=2, p_info=0.0,
                              max_pending=2)
    st = _port(engine=rung)
    sj = JSession("cas-register", engine="xla")
    per, per_j, segs = [], [], []
    for i in range(0, len(ht), 24):
        d0, g0 = TE.DISPATCHES, st.seg.n_segments
        st.append(ht[i:i + 24])
        per.append(TE.DISPATCHES - d0)
        segs.append(st.seg.n_segments - g0)
        d0 = JE.DISPATCHES
        sj.append(hj[i:i + 24])
        per_j.append(JE.DISPATCHES - d0)
    assert max(per) == 1, per
    assert sum(per) >= len(per) - 2, per
    assert all(n == 0 or p == 1 for n, p in zip(segs, per))
    assert st.replays == 0
    if rung == "xla":
        assert per == per_j
    assert st.dispatched_segments == st.seg.n_segments
    assert st.finalize_input()["valid"] is True


# --- the manager --------------------------------------------------------------

def test_manager_cap_and_eviction():
    mgr = SessionManager(max_sessions=2, idle_s=10.0, device="cpu")
    now = 100.0
    sid1, s1 = mgr.open(now)
    sid2, _s2 = mgr.open(now + 1)
    with pytest.raises(SessionLimit):
        mgr.open(now + 2)
    s1.append([TO.invoke(0, "write", 1), TO.ok(0, "write", 1)])
    assert mgr.carry_bytes() > 0
    mgr.get(sid2, now + 9)
    assert mgr.evict_idle(now + 12) == [sid1]
    assert len(mgr) == 1 and mgr.checkpoint_count() == 1
    assert mgr.evictions == 1
    restored = mgr.get(sid1, now + 13)
    assert restored is not None and mgr.restores == 1
    assert restored.device == torch.device("cpu")
    out = restored.append([TO.invoke(1, "read", None),
                           TO.Op(1, "ok", "read", 1)])
    assert out["valid"] is True and out["checked_through"] == 4


def test_eviction_forces_inflight_finalize():
    mgr = SessionManager(max_sessions=4, idle_s=10.0, device="cpu")
    sid, s = mgr.open(0.0)
    fin = s.append_stage([TO.invoke(0, "write", 1), TO.ok(0, "write", 1)])
    assert mgr.evict_idle(11.0) == [sid]
    out = fin()
    assert out["valid"] is True and out["checked_through"] == 2


def test_manager_open_restored_and_drop():
    mgr = SessionManager(max_sessions=1, idle_s=10.0, device="cpu")
    h = TSY.register_history(random.Random(9), n_procs=3, n_events=40)
    sid, s = mgr.open(0.0)
    s.append(h[:20])
    ck = mgr.checkpoint(sid)
    mgr.drop(sid)
    assert len(mgr) == 0
    sid2, s2 = mgr.open_restored(1.0, TCK.from_wire(TCK.to_wire(ck)))
    with pytest.raises(SessionLimit):
        mgr.open_restored(2.0, ck)
    s2.append(h[20:])
    out = mgr.close(sid2)
    _assert_verdict(_oneshot(h, "cas-register"), out)


# --- filetest --follow --------------------------------------------------------

def test_follow_reads_unterminated_final_line(tmp_path):
    """A last line without a trailing newline still contributes its op
    (here the violating read) once the idle timeout ends the stream."""
    from comdb2_tpu import filetest as JF

    h = [TO.invoke(0, "write", 1), TO.ok(0, "write", 1),
         TO.invoke(1, "read", None), TO.Op(1, "ok", "read", 9)]
    p = tmp_path / "hist.edn"
    p.write_text(history_to_edn(h))     # no trailing newline
    args = [str(p), "--follow", "--follow-idle", "0.3",
            "--follow-poll", "0.05"]
    assert TF.main(args + ["--device", "cpu"]) == 1
    assert JF.main(args) == 1


def test_follow_with_a_writer_thread(tmp_path, capsys):
    """A writer thread appends a history in 10 pieces, the last one
    unterminated: ``--follow`` ends with the exit code and verdict of
    ``filetest`` on the whole file."""
    import threading
    import time

    rng = random.Random(3)
    h = TSY.mutate(rng, TSY.register_history(random.Random(3),
                                             n_procs=5, n_events=300,
                                             values=5, p_info=0.0),
                   values=5)
    lines = history_to_edn(h).splitlines()
    p = tmp_path / "live.edn"
    p.write_text("")

    def writer():
        step = -(-len(lines) // 10)
        for i in range(0, len(lines), step):
            with open(p, "a") as fh:
                text = "\n".join(lines[i:i + step])
                fh.write(text if i + step >= len(lines) else text + "\n")
            time.sleep(0.02)

    th = threading.Thread(target=writer)
    th.start()
    rc = TF.main([str(p), "--follow", "--follow-idle", "0.4",
                  "--follow-poll", "0.01", "--device", "cpu"])
    th.join()
    out = capsys.readouterr().out
    rc_whole = TF.main([str(p), "--device", "cpu"])
    whole = capsys.readouterr().out
    assert rc == rc_whole == 1
    assert "'valid': False" in out and "'valid?': False" in whole
    want = TF.analysis(TMODELS["cas-register"](), h, device="cpu")
    assert f"'op_index': {want.op_index}" in out


def test_follow_rejects_other_checkers(tmp_path):
    p = tmp_path / "h.edn"
    p.write_text(history_to_edn([TO.invoke(0, "write", 1)]))
    assert TF.main([str(p), "--follow", "--checker", "set",
                    "--device", "cpu"]) == 3


# --- ingest edge cases --------------------------------------------------------

def test_info_before_invoke_does_not_retire_it():
    d1 = [TO.info(0, "write", None), TO.invoke(0, "write", None),
          TO.invoke(1, "write", 5)]
    d2 = [TO.ok(0, "write", 7), TO.ok(1, "write", 5)]
    ing = StreamIngest()
    lo, hi = ing.append(d1)
    assert hi == 1
    ing.append(d2)
    ing.finalize()
    packed, got = tpack(d1 + d2), ing.packed_history()
    for a in ARRAYS:
        np.testing.assert_array_equal(getattr(got, a),
                                      getattr(packed, a), err_msg=a)
    for t in TABLES:
        assert getattr(got, t) == getattr(packed, t), t


def test_fail_value_mismatch_leaves_ingest_untouched():
    ing = StreamIngest()
    ing.append([TO.invoke(0, "write", 1)])
    n0 = len(ing)
    with pytest.raises(MalformedDelta):
        ing.append([TO.fail(0, "write", 2)])
    assert len(ing) == n0
    lo, hi = ing.append([TO.ok(0, "write", 1)])
    assert hi == 2


def test_concurrency_past_the_ladder_latches_unknown():
    assert TE.STREAM_MAX_P == JE.STREAM_MAX_P
    assert TE.STREAM_MAX_K == JE.STREAM_MAX_K
    h = TSY.pinned_wide_history(TE.STREAM_MAX_P + 2, with_reads=False)
    s = _port()
    for i in range(0, len(h), 16):
        s.append(h[i:i + 16])
    out = s.finalize_input()
    assert out["valid"] == "unknown"
    assert out["cause"] == (
        f"concurrency beyond the stream ladder (P_eff={s.seg.p_eff} > "
        f"{TE.STREAM_MAX_P} or K={s.seg.k_max} > {TE.STREAM_MAX_K})")


def test_malformed_delta_latches_unknown():
    s = _port()
    out = s.append([TO.invoke(0, "write", 1), TO.invoke(0, "write", 2)])
    assert out["valid"] == "unknown" and "malformed" in out["cause"]
    r = s.append([TO.invoke(1, "write", 1)])
    assert r["valid"] == "unknown" and r.get("latched")


def test_append_finalize_is_idempotent():
    h = TSY.register_history(random.Random(6), n_procs=3, n_events=60,
                             p_info=0.0, max_pending=2)
    s = _port()
    cut = len(h) // 2
    fin1 = s.append_stage(h[:cut])
    fin2 = s.append_stage(h[cut:])
    d0 = s.dispatches
    r1a, r1b = fin1(), fin1()
    assert s.dispatches == d0 and r1a == r1b
    fin2()
    _assert_verdict(_oneshot(h, "cas-register"), s.finalize_input())


def test_unresolved_invokes_hold_the_watermark():
    s = _port()
    out = s.append([TO.invoke(0, "read", None), TO.invoke(1, "write", 1),
                    TO.ok(1, "write", 1)])
    assert out["checked_through"] == 0 and out["dispatches"] == 0
    out = s.append([TO.ok(0, "read", 1)])
    assert out["checked_through"] == 4 and out["valid"] is True


# --- the kernel rung's table, stride and errors --------------------------------

def _stride_history(pkg):
    h1 = [pkg.invoke(0, "write", 1), pkg.ok(0, "write", 1),
          pkg.invoke(1, "write", 2), pkg.ok(1, "write", 2),
          pkg.invoke(0, "read", None), pkg.ok(0, "read", 2)]
    h2 = [pkg.invoke(1, "write", 3), pkg.ok(1, "write", 3),
          pkg.invoke(0, "read", None), pkg.ok(0, "read", 3)]
    h3 = [pkg.invoke(0, "read", None), pkg.ok(0, "read", 1)]
    return h1, h2, h3


def _bucket_history():
    """h2 interns ONE new transition (write 3: four transitions, four
    states) — inside the (4, 4) bucket h1 (three and three) opened."""
    h1, _, h3 = _stride_history(TO)
    h2 = [TO.invoke(1, "write", 3), TO.ok(1, "write", 3),
          TO.invoke(1, "write", 2), TO.ok(1, "write", 2),
          TO.invoke(0, "read", None), TO.ok(0, "read", 2)]
    return h1, h2, h3


def test_kernel_rung_stride_and_table_growth(interpret_kernel):
    """A NON-pow2 transition count packs the bucket-padded table at
    the padded stride, and a delta interning a new transition WITHIN
    the same bucket re-uploads the table (a stale one misdecodes
    every later successor): per-append verdicts equal the JAX
    package's kernel rung."""
    hj, ht = _stride_history(JO), _stride_history(TO)
    sj = JSession("cas-register")
    st = _port(engine="kernel")
    for dj, dt in zip(hj, ht):
        _same_map(sj.append(dj), st.append(dt), KERNEL_MAP_KEYS)
    assert st._rung == sj._rung == "kernel"
    oj, ot = sj.finalize_input(), st.finalize_input()
    _same_map(oj, ot, KERNEL_MAP_KEYS)
    assert ot["replays"] == 0
    assert ot["valid"] is False
    _assert_verdict(_oneshot(sum(hj, []), "cas-register"), ot)


def test_table_reuploads_on_memo_version_inside_a_bucket():
    h1, h2, h3 = _bucket_history()
    s = _port(engine="kernel")
    s.append(h1)
    t1, k1 = s._table_dev, s._table_key
    ns, nt = s._eng.ns, s._eng.nt
    s.append(h2)
    assert (s._eng.ns, s._eng.nt) == (ns, nt)    # same bucket
    assert s._table_key != k1 and s._table_dev is not t1
    assert s._table_key[0] == s.memo.version
    want = LT.pad_succ(s.memo.succ, ns, nt).reshape(-1)
    np.testing.assert_array_equal(s._table_dev.numpy(), want)
    assert s.replays == 0
    assert s.append(h3)["valid"] is False


def test_kernel_spec_gates_on_the_padded_table():
    """A shape whose exact table fits ``MAX_TABLE`` but whose pow2
    padded one does not takes another rung — never the kernel's
    input check."""
    assert 65 * 100 <= SK.MAX_TABLE
    assert SK.spec_for(65, 100, 2, 2) is not None
    assert TE.kernel_spec(65, 100, 2, 1) is None
    assert TE.pick_rung(*TE.pad_sizes(65, 100), 2, 1) == "xla"
    assert JE.pick_rung(*JE.pad_sizes(65, 100), 2, 1) == "xla"
    assert TE.pick_rung(*TE.pad_sizes(70, 100), 2, 1) == "xla"
    assert TE.pick_rung(*TE.pad_sizes(60, 100), 2, 1) == "kernel"
    assert TE.pick_rung(64, 128, 2, 1) == "kernel"


def test_session_leaves_the_kernel_when_the_padded_table_outgrows_it():
    """69 distinct writes and 31 distinct reads grow the memo to 70
    states by 100 transitions (7000 exact entries, 16384 padded): the
    session starts on the kernel rung and re-routes to xla without
    error, to the one-shot verdict."""
    def hist(pkg):
        h = []
        for v in range(1, 70):
            h += [pkg.invoke(0, "write", v), pkg.ok(0, "write", v)]
            if v <= 31:
                h += [pkg.invoke(1, "read", None), pkg.ok(1, "read", v)]
        return h

    ht = hist(TO)
    s = _port()
    _, out = _feed(s, ht, seed=1, max_delta=20)
    assert (s.memo.n_states, s.memo.n_transitions) == (70, 100)
    assert s.engines_tried[0]["engine"] == "stream-kernel"
    assert out["engine"] == "xla" and out["replays"] >= 1
    _assert_verdict(_oneshot(hist(JO), "cas-register"), out)


def test_a_failed_launch_raises_out_of_append(monkeypatch):
    """Off the CPU the kernel rung launches the CUDA kernel; a failed
    launch (a stubbed ``_launch``) raises out of ``append`` — no
    fallback — and latches the session UNKNOWN."""
    def boom(*a, **k):
        raise RuntimeError("seg_search launch failed: CUDA error 700")

    monkeypatch.setattr(SK, "_launch", boom)
    s = StreamSession(engine="kernel", device="meta")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        s.append([TO.invoke(0, "write", 1), TO.ok(0, "write", 1)])
    out = s.poll()
    assert out["valid"] == "unknown"
    assert out["cause"].startswith("engine: RuntimeError")
    assert s.append([TO.invoke(1, "read", None)]).get("latched")


def test_without_cuda_the_entry_points_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SessionManager()
    p = tmp_path / "h.edn"
    p.write_text(history_to_edn([TO.invoke(0, "write", 1),
                                 TO.ok(0, "write", 1)]) + "\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.main([str(p), "--follow", "--follow-idle", "0.1"])


# --- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("rung", ["xla", "kernel", "mxu"])
def test_checkpoint_restore_resumes_bit_exact(rung):
    """A session checkpointed mid-stream, sent through the wire form
    and restored, finishes with the verdict and the carry bits of the
    uninterrupted session."""
    h = (TSY.pinned_wide_history(18) if rung == "mxu" else
         TSY.register_history(random.Random(12), n_procs=4,
                              n_events=80, p_info=0.0))
    a, b = _port(engine=rung), _port(engine=rung)
    cut = len(h) // 2
    a.append(h[:cut])
    b.append(h[:cut])
    wire = TCK.to_wire(b.checkpoint())
    assert TCK.wire_nbytes(wire) > 0
    c = StreamSession.restore(TCK.from_wire(wire), device="cpu")
    for s in (a, c):
        s.append(h[cut:])
    oa, oc = a.finalize_input(), c.finalize_input()
    assert oa == oc
    ea, ec = a.checkpoint()["eng"], c.checkpoint()["eng"]
    assert ea.keys() == ec.keys()
    for k in ea:
        if k == "carry":
            for x, y in zip(ea[k], ec[k]):
                for u, v in zip(*((x, y) if isinstance(x, tuple)
                                  else ((x,), (y,)))):
                    np.testing.assert_array_equal(u, v)
        elif isinstance(ea[k], np.ndarray):
            np.testing.assert_array_equal(ea[k], ec[k])
        else:
            assert ea[k] == ec[k], k


def test_wire_bytes_equal_the_jax_package():
    """The codec is the JAX package's: the same checkpoint dict encodes
    to the same bytes, and a JAX-package xla-rung checkpoint's host
    parts equal the port's."""
    hj = JSY.register_history(random.Random(5), n_procs=3, n_events=50)
    ht = TSY.register_history(random.Random(5), n_procs=3, n_events=50)
    sj, st = JSession("cas-register", engine="xla"), _port(engine="xla")
    sj.append(hj[:30])
    st.append(ht[:30])
    cj, ct = sj.checkpoint(), st.checkpoint()
    import json

    for ck in (cj, ct):
        assert json.dumps(TCK.to_wire(ck)) == json.dumps(JCK.to_wire(ck))
        assert TCK.wire_nbytes(TCK.to_wire(ck)) == \
            JCK.wire_nbytes(JCK.to_wire(ck))
    for part in ("memo", "ingest", "seg"):
        assert json.dumps(TCK.to_wire(cj[part])) == \
            json.dumps(TCK.to_wire(ct[part]))
    ej, et = cj["eng"], ct["eng"]
    assert {k: ej[k] for k in ("rung", "ns", "nt", "P2", "cap_ix")} == \
        {k: et[k] for k in ("rung", "ns", "nt", "P2", "cap_ix")}
    for x, y in zip(ej["carry"], et["carry"]):
        assert x.dtype == y.dtype and x.shape == y.shape
    assert _seg_configs(ej["carry"], et["P2"]) == \
        _seg_configs(et["carry"], et["P2"])


@pytest.mark.parametrize("form", ["dict", "wire"])
def test_jax_package_kernel_checkpoint_restores_in_the_port(
        interpret_kernel, form):
    """A kernel-rung checkpoint made by the JAX package (interpret
    mode) becomes the port's through ``convert.session_checkpoint``;
    the restored port session carries the same frontier bits as a port
    session fed the same prefix, and both packages finish the history
    with the one-shot verdict."""
    name, model, hj, ht = FAMILIES[0]
    cut = len(hj) // 2
    sj = JSession(model, engine="kernel")
    st = _port(model, engine="kernel")
    sj.append(hj[:cut])
    st.append(ht[:cut])
    ck = sj.checkpoint()
    assert ck["eng"]["rung"] == "kernel"
    src = JCK.to_wire(ck) if form == "wire" else ck
    moved = StreamSession.restore(convert.session_checkpoint(src, "cpu"),
                                  device="cpu")
    assert torch.equal(moved._eng.ws, st._eng.ws)
    assert torch.equal(moved._eng.stat, st._eng.stat)
    outs = []
    for s, h in ((sj, hj), (moved, ht), (st, ht)):
        s.append(h[cut:])
        outs.append(s.finalize_input())
    for o in outs[1:]:
        _same_map(outs[0], o, KERNEL_MAP_KEYS)
    _assert_verdict(_oneshot(hj, model), outs[1])
    assert torch.equal(moved._eng.ws, st._eng.ws)


def test_counterexample_matches_the_jax_package():
    name, model, hj, ht = FAMILIES[3]
    sj = JSession(model, engine="xla")
    st = _port(model, engine="xla")
    _feed(sj, hj)
    _feed(st, ht)
    cj, ct = sj.counterexample(), st.counterexample()
    assert ct is not None and cj is not None
    assert ct.op_index == cj.op_index
    assert ct.configs == cj.configs
    assert _port(model).counterexample() is None


def test_shape_class_and_carry_bytes():
    s = _port(engine="kernel")
    assert s.shape_class.startswith("stream-new")
    s.append([TO.invoke(0, "write", 1), TO.ok(0, "write", 1)])
    assert s.shape_class == "stream-kernel-p2-k2-t2x1"
    assert s.carry_nbytes() == s._eng.ws.numel() * 4 + 16
    s.close()
    assert s.carry_nbytes() == 0 and s.closed
    out = s.append([TO.invoke(0, "write", 2)])
    assert out["cause"] == "session closed"


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_kernel_growth_reencodes_the_replayed_frontier(seed):
    """Table-bucket, K and slot growth on the kernel rung re-encode the
    carry in place; the words equal those a replay of the retained
    segments rebuilds under the final spec, bit for bit."""
    h = TSY.register_history(random.Random(seed), n_procs=6,
                             n_events=200, values=4, p_info=0.0,
                             max_pending=4)
    s = _port(engine="kernel")
    specs = set()
    for a, b in _deltas(len(h), seed, 17):
        s.append(h[a:b])
        if s._eng is not None:
            specs.add(s._eng.spec)
    assert len(specs) >= 3 and s.replays == 0 and s._rung == "kernel"
    ws, stat = s._eng.ws.clone(), s._eng.stat.clone()
    s._reroute(note="check")
    assert s._rung == "kernel" and s._eng.spec in specs
    assert torch.equal(s._eng.ws, ws) and torch.equal(s._eng.stat, stat)
    cfgs = SK.decode_frontier(s._eng.spec, ws, s.P2)
    np.testing.assert_array_equal(
        SK.encode_frontier(s._eng.spec, cfgs), ws.numpy())


def test_kernel_overflow_replays_once_onto_xla():
    """A 10-process history overflows the kernel's 128 configs: ONE
    replay moves the session to the xla rung, which then escalates in
    place; later slot growth never sends it back to the kernel (a
    replay from segment 0 would overflow there again). The verdict is
    the JAX package's host checker's."""
    hj = JSY.register_history(random.Random(77), n_procs=10,
                              n_events=300, values=5, p_info=0.0,
                              max_pending=10)
    ht = TSY.register_history(random.Random(77), n_procs=10,
                              n_events=300, values=5, p_info=0.0,
                              max_pending=10)
    s = _port()
    for i in range(0, len(ht), 32):
        s.append(ht[i:i + 32])
    out = s.finalize_input()
    assert out["engine"] == "xla" and out["replays"] == 1
    assert out["engines_tried"] == [{"engine": "stream-kernel",
                                     "note": "frontier overflow",
                                     "frontier_capacity": 128}]
    assert out["frontier_capacity"] > TE.STREAM_CAPACITIES[0]
    from comdb2_tpu.checker import linear_host as JLH
    from comdb2_tpu.models.memo import memo as jmemo

    packed = jpack(hj)
    want = JLH.check(jmemo(JMODELS["cas-register"](), packed), packed)
    assert out["valid"] is want.valid is True
    assert out["final_count"] == want.final_count
