"""The port's megabatched session advance against solo sessions and
the JAX package, on CPU.

N same-class sessions advance in ONE device call per beat
(``stream.engine.MegaBatch``). The claims, asserted on the port's
``DISPATCHES`` / ``MEGABATCHES`` counters and on carry bits:

- a fused beat's carries are BIT-equal to B solo dispatches on all
  three rungs (xla, mxu, kernel), mixed per-lane delta sizes included;
- a latched lane never joins a beat;
- a mid-beat escalation widens that lane in place, its beat-mates
  untouched;
- a lane checkpointed out of a fused beat restores bit-exact;
- verdicts equal the JAX package's one-shot check, and the lanes of a
  beat are the JAX package's megabatch lanes, in one call per rung
  (the lanes run one after another, so they need not share a shape).
"""

import random

import numpy as np
import pytest
import torch

from comdb2_tpu.checker.batch import check_batch, pack_batch
from comdb2_tpu.models.model import MODELS as JMODELS
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JSY
from comdb2_tpu.ops.packed import pack_history as jpack
from comdb2_tpu.stream import StreamSession as JSession
from comdb2_tpu.stream import engine as JE

from comdb2_tpu_torch.checker import mxu as TMX
from comdb2_tpu_torch.obs import trace as TTR
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TSY
from comdb2_tpu_torch.stream import StreamSession
from comdb2_tpu_torch.stream import engine as TE

V = {True: 0, False: 1, "unknown": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(engine, model="cas-register"):
    return StreamSession(model, engine=engine, device="cpu")


def _oneshot(h, model="cas-register", F=1024):
    b = pack_batch([jpack(list(h))], JMODELS[model]())
    st, fa, nf = check_batch(b, F=F)
    return int(st[0]), int(fa[0]), int(nf[0])


def _assert_verdict(exp, out):
    got = (V[out["valid"]], out["op_index"], out["final_count"])
    assert exp[0] == got[0] and exp[1] == got[1], (exp, got)
    if exp[0] == 0:
        assert exp[2] == got[2], (exp, got)


def _fused_beat(sessions, deltas, mb=TE.MegaBatch):
    coll = mb()
    fins = [s.append_stage(d, collector=coll)
            for s, d in zip(sessions, deltas)]
    coll.flush()
    return [f() for f in fins], coll


def _assert_state_equal(a, b, path=""):
    """Recursive bit-exact compare of engine checkpoint trees."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _assert_session_parity(fused, solo):
    fo, so = fused.poll(), solo.poll()
    assert fo == so, (fo, so)
    assert fused.dispatches == solo.dispatches
    _assert_state_equal(fused.checkpoint()["eng"],
                        solo.checkpoint()["eng"])


def _registers(pkg, seeds, n_events=36):
    return [pkg.register_history(random.Random(s), n_procs=3,
                                 n_events=n_events, p_info=0.0,
                                 max_pending=2) for s in seeds]


# --- bit parity, fused vs solo ------------------------------------------------

def test_xla_fused_bit_parity_mixed_deltas():
    """Three xla lanes with DIFFERENT per-beat delta sizes advance in
    one call per beat; carries and verdicts are bit-equal to solo
    sessions, and the lanes and per-session counters are the JAX
    package's (which makes one call per shape class)."""
    hs = _registers(TSY, (21, 22, 23))
    hj = _registers(JSY, (21, 22, 23))
    cuts = [24, 12, 30]
    fused = [_port("xla") for _ in hs]
    solo = [_port("xla") for _ in hs]
    jfused = [JSession("cas-register", engine="xla") for _ in hj]
    for part in range(2):
        beats = [h[:c] if part == 0 else h[c:] for h, c in zip(hs, cuts)]
        jbeats = [h[:c] if part == 0 else h[c:] for h, c in zip(hj, cuts)]
        d0, m0 = TE.DISPATCHES, TE.MEGABATCHES
        outs, coll = _fused_beat(fused, beats)
        jouts, jcoll = _fused_beat(jfused, jbeats, JE.MegaBatch)
        assert TE.DISPATCHES - d0 == len(coll.lane_counts)
        assert TE.MEGABATCHES - m0 == coll.fused_launches
        # the same lanes joined; the port makes ONE call of them where
        # the JAX package makes one per shape class
        assert sum(coll.lane_counts) == sum(jcoll.lane_counts)
        assert len(coll.lane_counts) == 1
        assert len(jcoll.lane_counts) >= 1
        for s, b in zip(solo, beats):
            s.append(b)
        for o, jo in zip(outs, jouts):
            assert (o["valid"], o["op_index"], o["dispatches"]) == \
                (jo["valid"], jo["op_index"], jo["dispatches"])
    assert max(coll.lane_counts) == 3 and coll.masked_lanes >= 1
    for f, s, h in zip(fused, solo, hj):
        _assert_session_parity(f, s)
        exp = _oneshot(h)
        _assert_verdict(exp, f.finalize_input())
        _assert_verdict(exp, s.finalize_input())


def _kernel_hist(pkg, v1, v2):
    return ([pkg.invoke(0, "write", v1), pkg.ok(0, "write", v1),
             pkg.invoke(1, "write", v2), pkg.ok(1, "write", v2),
             pkg.invoke(0, "read", None), pkg.ok(0, "read", v2)],
            [pkg.invoke(1, "write", v1), pkg.ok(1, "write", v1),
             pkg.invoke(0, "read", None), pkg.ok(0, "read", v1)])


def test_kernel_fused_bit_parity():
    """Two kernel-rung lanes share one beat: B launches and ONE
    readback of all B stats (the engines hold their host stats after
    the flush, so the finalizes read nothing more), bit-equal to solo
    twins."""
    ha, hb = _kernel_hist(TO, 1, 2), _kernel_hist(TO, 2, 1)
    fused = [_port("kernel") for _ in (0, 1)]
    solo = [_port("kernel") for _ in (0, 1)]
    for part in range(2):
        beats = [ha[part], hb[part]]
        d0 = TE.DISPATCHES
        coll = TE.MegaBatch()
        fins = [s.append_stage(d, collector=coll)
                for s, d in zip(fused, beats)]
        coll.flush()
        assert all(s._eng._read is not None for s in fused)
        [f() for f in fins]
        assert coll.fused_launches == 1, coll.lane_counts
        assert TE.DISPATCHES - d0 == 1
        for s, b in zip(solo, beats):
            s.append(b)
    assert all(s._rung == "kernel" for s in fused + solo)
    for f, s, h in zip(fused, solo, (_kernel_hist(JO, 1, 2),
                                     _kernel_hist(JO, 2, 1))):
        _assert_session_parity(f, s)
        exp = _oneshot(h[0] + h[1])
        _assert_verdict(exp, f.finalize_input())
        _assert_verdict(exp, s.finalize_input())


def test_mxu_fused_bit_parity():
    """Two wide-P lanes on the MXU rung advance in one call
    (``check_device_mxu_megabatch``, counted once), bit-equal to solo
    twins."""
    wide = TSY.pinned_wide_history(18)
    tail = [TO.invoke(0, "write", 2), TO.ok(0, "write", 2),
            TO.invoke(1, "read", None), TO.ok(1, "read", 2)]
    fused = [_port("mxu") for _ in (0, 1)]
    solo = [_port("mxu") for _ in (0, 1)]
    for s in fused + solo:
        s.append(wide)
    assert all(s._rung == "mxu" for s in fused + solo)
    d0, m0, x0 = TE.DISPATCHES, TE.MEGABATCHES, TMX.DISPATCHES
    outs, coll = _fused_beat(fused, [list(tail), list(tail)])
    assert TE.DISPATCHES - d0 == 1 and TE.MEGABATCHES - m0 == 1
    assert TMX.DISPATCHES - x0 == 1
    assert coll.lane_counts == [2]
    for s in solo:
        s.append(tail)
    for f, s in zip(fused, solo):
        _assert_session_parity(f, s)
        assert f.poll()["valid"] is True


@pytest.mark.parametrize("n_lanes", [2, 3, 5, 8, 16, 17])
@pytest.mark.parametrize("rung", ["xla", "kernel"])
def test_fused_lanes_equal_solo_at_every_lane_count(rung, n_lanes):
    """Up the ``MEGABATCH_LANES`` ladder and past its top (17 lanes
    split into 16 + a solo lane): one call per rung-group, the padding
    lanes counted and never run, every carry bit-equal to solo."""
    hs = _registers(TSY, range(100, 100 + n_lanes), n_events=24)
    fused = [_port(rung) for _ in hs]
    solo = [_port(rung) for _ in hs]
    for part in range(2):
        beats = [h[:12] if part == 0 else h[12:] for h in hs]
        d0 = TE.DISPATCHES
        before = [s.dispatches for s in fused]
        r0 = sum(s.replays for s in fused)
        outs, coll = _fused_beat(fused, beats)
        if sum(s.replays for s in fused) == r0:
            # a re-route (the kernel rung on table growth) replays
            # solo, outside the beat's calls
            assert TE.DISPATCHES - d0 == len(coll.lane_counts)
        for s, b in zip(solo, beats):
            s.append(b)
        joined = sum(s.dispatches > b0 for s, b0 in zip(fused, before))
        assert sum(coll.lane_counts) <= joined
        assert max(coll.lane_counts, default=0) <= TE.MEGABATCH_LANES[-1]
        assert coll.masked_lanes == sum(
            next(b for b in TE.MEGABATCH_LANES if b >= n) - n
            for n in coll.lane_counts if n > 1)
        if n_lanes > TE.MEGABATCH_LANES[-1] and part == 1:
            assert len(coll.lane_counts) >= 2
    for f, s in zip(fused, solo):
        _assert_session_parity(f, s)


# --- beat-local failure modes ----------------------------------------------------

def test_mid_batch_latch():
    good = [TO.invoke(0, "write", 1), TO.ok(0, "write", 1),
            TO.invoke(1, "read", None), TO.ok(1, "read", 1)]
    bad = [TO.invoke(0, "write", 1), TO.ok(0, "write", 1),
           TO.invoke(1, "read", None), TO.ok(1, "read", 9)]
    sa, sb = _port("xla"), _port("xla")
    outs, coll = _fused_beat([sa, sb], [bad, list(good)])
    assert coll.fused_launches == 1
    assert outs[0]["valid"] is False and outs[1]["valid"] is True
    more = [TO.invoke(2, "write", 2), TO.ok(2, "write", 2),
            TO.invoke(0, "read", None), TO.ok(0, "read", 2)]
    d0, da0 = TE.DISPATCHES, sa.dispatches
    outs, coll = _fused_beat([sa, sb], [list(more), list(more)])
    assert outs[0]["valid"] is False and outs[0].get("latched")
    assert outs[1]["valid"] is True
    assert sa.dispatches == da0 and TE.DISPATCHES - d0 == 1
    assert coll.lane_counts == [1] and coll.fused_launches == 0


def test_mid_batch_escalation_widens_in_place():
    burst = [TO.invoke(p, "write", p) for p in range(8)]
    tail = [TO.ok(p, "write", p) for p in range(8)]
    tail += [TO.invoke(0, "read", None), TO.ok(0, "read", 7)]
    calm = TSY.register_history(random.Random(31), n_procs=3,
                                n_events=20, p_info=0.0, max_pending=2)
    cut = 12
    sa, sb, solo_b = _port("xla"), _port("xla"), _port("xla")
    _fused_beat([sa, sb], [burst, calm[:cut]])
    solo_b.append(calm[:cut])
    _fused_beat([sa, sb], [tail, calm[cut:]])
    solo_b.append(calm[cut:])
    jburst = [JO.invoke(p, "write", p) for p in range(8)]
    jtail = [JO.ok(p, "write", p) for p in range(8)]
    jtail += [JO.invoke(0, "read", None), JO.ok(0, "read", 7)]
    out_a = sa.finalize_input()
    _assert_verdict(_oneshot(jburst + jtail, F=8192), out_a)
    assert out_a["frontier_capacity"] > TE.STREAM_CAPACITIES[0]
    assert out_a["replays"] == 0
    _assert_session_parity(sb, solo_b)
    jcalm = JSY.register_history(random.Random(31), n_procs=3,
                                 n_events=20, p_info=0.0, max_pending=2)
    _assert_verdict(_oneshot(jcalm), sb.finalize_input())


def test_lane_checkpoint_restore_out_of_fused_beat():
    hs = _registers(TSY, (41, 42), n_events=32)
    hj = _registers(JSY, (41, 42), n_events=32)
    cut = 16
    ss = [_port("xla") for _ in hs]
    _fused_beat(ss, [h[:cut] for h in hs])
    ck = ss[0].checkpoint()
    moved = StreamSession.restore(ck, device="cpu")
    _assert_state_equal(ck["eng"], moved.checkpoint()["eng"])
    outs, coll = _fused_beat([moved, ss[1]], [h[cut:] for h in hs])
    assert coll.fused_launches == 1
    for s, h in zip((moved, ss[1]), hj):
        _assert_verdict(_oneshot(h), s.finalize_input())


def test_second_append_flushes_the_parked_delta():
    """A second append to a session whose delta is still parked in the
    collector forces the flush first: the carry it reads saw the
    delta."""
    h = _registers(TSY, (61,), n_events=40)[0]
    s, twin = _port("xla"), _port("xla")
    coll = TE.MegaBatch()
    fin = s.append_stage(h[:20], collector=coll)
    out = s.append(h[20:])
    assert fin()["valid"] is True and not coll._groups
    twin.append(h[:20])
    assert out == twin.append(h[20:])


def test_megabatch_span_and_failed_group_latches(monkeypatch):
    """Each device call records a ``stream.megabatch`` span (rung,
    lanes, masked); a group call that raises latches every session
    of the beat UNKNOWN and raises out of the flush."""
    hs = _registers(TSY, (71,), n_events=24) * 3
    ss = [_port("xla") for _ in hs]
    TTR.clear()
    TTR.enable()
    try:
        _fused_beat(ss, [h[:12] for h in hs])
        spans = [sp for sp in TTR.spans() if sp.name == "stream.megabatch"]
    finally:
        TTR.disable()
        TTR.clear()
    assert [sp.args["lanes"] for sp in spans] == [3]
    assert spans[0].args["masked"] == 1 and spans[0].args["rung"] == "xla"

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(TE, "stream_delta_megabatch", boom)
    coll = TE.MegaBatch()
    fins = [s.append_stage(h[12:], collector=coll)
            for s, h in zip(ss, hs)]
    with pytest.raises(RuntimeError, match="device lost"):
        coll.flush()
    for s in ss:
        assert s.poll()["valid"] == "unknown"
        assert s.cause == "engine: RuntimeError: device lost"
    assert fins[0]()["valid"] == "unknown"


def test_mxu_megabatch_entry_equals_chunk_calls():
    """``check_device_mxu_megabatch`` directly: lanes with their own
    tables and depths come out bit-equal to one chunk call each."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history

    lanes = []
    for seed in (5, 6):
        h = TSY.register_history(random.Random(seed), n_procs=4,
                                 n_events=40, p_info=0.0)
        packed = pack_history(h)
        mm = memo(cas_register(), packed)
        segs, _ = LT.remap_slots(LT.make_segments(packed, s_pad=64,
                                                  k_pad=4))
        succ = torch.from_numpy(LT.pad_succ(mm.succ, 16, 32))
        lanes.append((succ, segs))
    kw = dict(F=1024, P=16, n_states=16, n_transitions=32)
    carries = tuple(TMX.init_carry(1, 1024, 16, 16, 32, "cpu")
                    for _ in lanes)
    args = [np.stack([getattr(s, f) for _, s in lanes])
            for f in ("inv_proc", "inv_tr", "ok_proc", "depth")]
    outs = TMX.check_device_mxu_megabatch(
        tuple(s for s, _ in lanes), *args, np.array([0, 7]), carries,
        device="cpu", **kw)
    for (succ, segs), off, c0, got in zip(lanes, (0, 7), carries, outs):
        want = TMX.check_device_mxu_chunk(
            succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth,
            off, c0, device="cpu", **kw)
        for x, y in zip(want, got):
            for u, v in zip(*((x, y) if isinstance(x, tuple)
                              else ((x,), (y,)))):
                assert torch.equal(u, v)
