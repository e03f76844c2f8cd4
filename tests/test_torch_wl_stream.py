"""The port's workload-family stream sessions (bank / sets) against the
JAX package, on CPU.

Stream verdicts equal the JAX package's stream sessions and its
one-shot ``check_wl_batch`` on valid and violation twins (made by both
packages' ``checker.wl.synth`` from one seed); appends dispatch
O(delta) (counter-asserted, equal to the JAX package's counts);
megabatched advances are bit-identical to solo ones (verdicts AND
carry bits); verdicts latch; checkpoints round-trip through host numpy
and through the wire form, between the packages too. The delta forms
themselves (``wl_bank_delta``, ``wl_sets_delta`` and their megabatch
forms) are held exactly against the JAX package's on seeded planes.
"""

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import wl as JW
from comdb2_tpu.stream import engine as JE
from comdb2_tpu.stream import wl as JSW

from comdb2_tpu_torch.checker import wl as TW
from comdb2_tpu_torch.checker.wl import bank as TB
from comdb2_tpu_torch.checker.wl import sets as TS
from comdb2_tpu_torch.ops.op import invoke, ok
from comdb2_tpu_torch.stream import checkpoint as TCK
from comdb2_tpu_torch.stream import engine as TE
from comdb2_tpu_torch.stream import wl as TSW
from comdb2_tpu_torch.stream.manager import SessionManager


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(model, params=None):
    return TSW.make_session(model, params, device="cpu")


def _thirds(h):
    t = len(h) // 3
    return [h[:t], h[t:2 * t], h[2 * t:]]


# --- the delta forms -----------------------------------------------------------

def _bank_planes(seed, B=None, r=8, t=8, a=8):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    bal = rng.integers(-50, 50, lead + (a,), dtype=np.int32)
    tr = rng.integers(-5, 6, lead + (t, a), dtype=np.int32)
    snaps = np.concatenate([np.zeros_like(tr[..., :1, :]),
                            np.cumsum(tr, axis=-2, dtype=np.int32)],
                           axis=-2) + bal[..., None, :]
    # reads: some snapshots (legal), some perturbed, some wrong-n
    pick = rng.integers(0, t + 1, lead + (r,))
    reads = np.take_along_axis(snaps, pick[..., None], axis=-2).copy()
    reads[..., 1, 0] += rng.integers(1, 3)
    mask = rng.random(lead + (r,)) < 0.8
    wrong_n = rng.random(lead + (r,)) < 0.15
    total = snaps[..., 0, :].sum(-1, dtype=np.int32)
    return bal, reads, mask, wrong_n, tr, total


@pytest.mark.parametrize("seed", range(4))
def test_wl_bank_delta_matches_the_jax_package(seed):
    bal, reads, mask, wn, tr, total = _bank_planes(seed)
    kw = dict(n_reads=8, n_accounts=8, n_snaps=8)
    want = JW.wl_bank_delta(bal, reads, mask, wn, tr, np.int32(total),
                            **kw)
    got = TB.wl_bank_delta(*(torch.from_numpy(x) for x in
                             (bal, reads, mask, wn, tr)), int(total), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_wl_bank_delta_mb_matches_solo_and_the_jax_package(seed):
    B = 4
    bal, reads, mask, wn, tr, total = _bank_planes(100 + seed, B=B)
    kw = dict(n_reads=8, n_accounts=8, n_snaps=8)
    want = JW.wl_bank_delta_mb(tuple(bal), reads, mask, wn, tr,
                               total.astype(np.int32), **kw)
    t = [torch.from_numpy(x) for x in (bal, reads, mask, wn, tr, total)]
    got = TB.wl_bank_delta_mb(tuple(t[0]), *t[1:], **kw)
    for b in range(B):
        solo = TB.wl_bank_delta(t[0][b], t[1][b], t[2][b], t[3][b],
                                t[4][b], int(total[b]), **kw)
        for w, g, s in zip(want[b], got[b], solo):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert torch.equal(g, s)


def _sets_planes(seed, B=None, e=128):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    planes = [rng.random(lead + (e,)) < p
              for p in (0.5, 0.3, 0.4, 0.2, 0.1, 0.4)]
    hrd = rng.random(lead) < 0.6
    hr = hrd | (rng.random(lead) < 0.5)
    return planes, np.asarray(hrd), np.asarray(hr)


@pytest.mark.parametrize("seed", range(4))
def test_wl_sets_delta_matches_the_jax_package(seed):
    (att, add, fr, att_d, add_d, rd), hrd, hr = _sets_planes(seed)
    want = JW.wl_sets_delta(att, add, fr, att_d, add_d, rd, hrd, hr,
                            n_elems=128)
    got = TS.wl_sets_delta(*(torch.from_numpy(x) for x in
                             (att, add, fr, att_d, add_d, rd)),
                           bool(hrd), bool(hr), n_elems=128)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_wl_sets_delta_mb_matches_solo_and_the_jax_package(seed):
    B = 3
    (att, add, fr, att_d, add_d, rd), hrd, hr = _sets_planes(50 + seed,
                                                             B=B)
    carries = tuple(zip(att, add, fr))
    want = JW.wl_sets_delta_mb(carries, att_d, add_d, rd, hrd, hr,
                               n_elems=128)
    T = torch.from_numpy
    got = TS.wl_sets_delta_mb(
        tuple(tuple(T(x) for x in c) for c in carries), T(att_d),
        T(add_d), T(rd), hrd, hr, n_elems=128)
    for b in range(B):
        solo = TS.wl_sets_delta(T(att[b]), T(add[b]), T(fr[b]),
                                T(att_d[b]), T(add_d[b]), T(rd[b]),
                                bool(hrd[b]), bool(hr[b]), n_elems=128)
        for w, g, s in zip(want[b], got[b], solo):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert torch.equal(g, s)


def test_delta_pads_are_the_jax_package_ladder():
    assert TW.WL_DELTA_PADS == JW.WL_DELTA_PADS
    assert TSW.WL_MODELS == JSW.WL_MODELS


# --- bank ------------------------------------------------------------------------

@pytest.mark.parametrize("viol", [None, "total", "n"])
def test_bank_stream_matches_one_shot(viol):
    hists, model = TW.bank_batch(7, 3, violation=viol)
    jh, jmodel = JW.bank_batch(7, 3, violation=viol)
    one = JW.check_wl_batch(jh, "bank", jmodel)
    for h, hj, o in zip(hists, jh, one):
        s = _session("wl-bank", model)
        sj = JSW.make_session("wl-bank", jmodel)
        d0, j0 = TE.DISPATCHES, JE.DISPATCHES
        for part, pj in zip(_thirds(h), _thirds(hj)):
            s.append(part)
            sj.append(pj)
        assert TE.DISPATCHES - d0 == JE.DISPATCHES - j0 <= 3
        out, oj = s.close(), sj.close()
        assert out == oj
        assert out["valid"] == o["valid?"], (viol, out, o)
        if viol in ("total", "n"):
            kind = "wrong-n" if viol == "n" else "wrong-total"
            assert out["cause"] == f"{kind} read", out


def test_bank_snapshot_plane_stream():
    hists, model = TW.bank_batch(9, 2, violation="snapshot")
    jh, jmodel = JW.bank_batch(9, 2, violation="snapshot")
    for h, hj in zip(hists, jh):
        s = _session("wl-bank", model)
        sj = JSW.make_session("wl-bank", jmodel)
        s.append(h)
        sj.append(hj)
        out = s.close()
        assert out == sj.close()
        assert out["valid"] is True and out["snapshot_inconsistent"] >= 1


def test_bank_megabatch_bit_parity():
    hists, model = TW.bank_batch(11, 6)
    solo = []
    for h in hists:
        s = _session("wl-bank", model)
        fin = s.append_stage(h)
        solo.append((fin(), s._balance.clone()))
        s.close()
    d0, m0 = TE.DISPATCHES, TE.MEGABATCHES
    sess = [_session("wl-bank", model) for _ in hists]
    coll = TE.MegaBatch()
    fins = [s.append_stage(h, collector=coll)
            for s, h in zip(sess, hists)]
    coll.flush()
    assert TE.DISPATCHES - d0 == 1 and TE.MEGABATCHES - m0 == 1
    assert coll.fused_launches == 1 and coll.fused_lanes == 6
    assert coll.masked_lanes == 2
    for s, fin, (so, sbal) in zip(sess, fins, solo):
        fo = fin()
        assert fo == so
        assert torch.equal(s._balance, sbal)
        s.close()


def test_bank_latch():
    hists, model = TW.bank_batch(13, 1, violation="total")
    s = _session("wl-bank", model)
    s.append(hists[0])
    d0 = TE.DISPATCHES
    out = s.append(hists[0][:4])
    assert out["valid"] is False and out.get("latched") is True
    assert TE.DISPATCHES == d0


def test_bank_checkpoint_restore():
    hists, model = TW.bank_batch(17, 1)
    h = hists[0]
    s = _session("wl-bank", model)
    s.append(h[:len(h) // 2])
    ck = s.checkpoint()
    assert ck["wl_family"] == "bank"
    assert isinstance(ck["balance"], np.ndarray)
    s2 = TSW.restore_session(TCK.from_wire(TCK.to_wire(ck)), device="cpu")
    s.append(h[len(h) // 2:])
    s2.append(h[len(h) // 2:])
    o1, o2 = s.close(), s2.close()
    assert o1 == o2 and o1["valid"] is True


def test_bank_checkpoint_crosses_from_the_jax_package():
    """A JAX-package bank session's checkpoint (its wire form) restores
    in the port and finishes with the JAX package's verdict."""
    jh, jmodel = JW.bank_batch(19, 1, violation="total")
    th, model = TW.bank_batch(19, 1, violation="total")
    cut = len(jh[0]) // 2
    sj = JSW.make_session("wl-bank", jmodel)
    sj.append(jh[0][:cut])
    from comdb2_tpu.stream import checkpoint as JCK
    from comdb2_tpu_torch import convert

    ck = convert.session_checkpoint(JCK.to_wire(sj.checkpoint()), "cpu")
    st = TSW.restore_session(ck, device="cpu")
    sj.append(jh[0][cut:])
    st.append(th[0][cut:])
    assert st.close() == sj.close()


def test_bank_oversized_append_chunks():
    hists, model = TW.bank_batch(50, 1, n_transfers=100, n_reads=80)
    jh, jmodel = JW.bank_batch(50, 1, n_transfers=100, n_reads=80)
    one = JW.check_wl_batch(jh, "bank", jmodel)
    s = _session("wl-bank", model)
    sj = JSW.make_session("wl-bank", jmodel)
    d0, j0 = TE.DISPATCHES, JE.DISPATCHES
    s.append(hists[0])
    sj.append(jh[0])
    nd = TE.DISPATCHES - d0
    assert nd >= 2 and nd == JE.DISPATCHES - j0
    out = s.close()
    assert out["valid"] == one[0]["valid?"] and out == sj.close()


# --- sets -------------------------------------------------------------------------

@pytest.mark.parametrize("viol", [None, "lost", "phantom"])
def test_sets_stream_matches_one_shot(viol):
    hists = TW.sets_batch(5, 3, violation=viol)
    jh = JW.sets_batch(5, 3, violation=viol)
    one = JW.check_wl_batch(jh, "sets")
    for h, hj, o in zip(hists, jh, one):
        s = _session("wl-sets")
        sj = JSW.make_session("wl-sets")
        half = len(h) // 2
        r1 = s.append(h[:half])
        assert r1 == sj.append(hj[:half])
        assert r1["valid"] is True
        assert s.append(h[half:]) == sj.append(hj[half:])
        out = s.close()
        assert out == sj.close()
        assert out["valid"] == o["valid?"], (viol, out, o)


def test_sets_never_read_unknown():
    s = _session("wl-sets")
    h = TW.sets_batch(6, 1)[0]
    s.append([op for op in h if op.f != "read"])
    out = s.close()
    assert out["valid"] == "unknown" and out["cause"] == "Set was never read"


def test_sets_malformed_read_latches_unknown():
    s = _session("wl-sets")
    s.append([ok(0, "read", "abc")])
    out = s.poll()
    assert out["valid"] == "unknown" and "malformed" in out["cause"]


def test_sets_escalation_in_place():
    s = _session("wl-sets")
    ops = []
    for v in range(300):
        ops.append(invoke(v, "add", v))
        ops.append(ok(v, "add", v))
    s.append(ops[:100])
    assert s.e_pad == 128
    s.append(ops[100:])
    assert s.e_pad == 1024 and s.escalations == 1
    assert s._att.shape == (1024,)
    s.append([ok(301, "read", tuple(range(300)))])
    out = s.close()
    assert out["valid"] is True, out


def test_sets_past_the_ladder_latches_unknown():
    s = _session("wl-sets")
    ops = [ok(0, "add", v) for v in range(TW.WL_ELEMS[-1] + 1)]
    out = s.append(ops)
    assert out["valid"] == "unknown"
    assert "WL_ELEMS ladder" in out["cause"]


def test_sets_megabatch_bit_parity():
    hists = TW.sets_batch(21, 4)
    solo = []
    for h in hists:
        s = _session("wl-sets")
        s.append(h)
        solo.append((s.poll(), s._fr.clone()))
        s.close()
    d0, m0 = TE.DISPATCHES, TE.MEGABATCHES
    sess = [_session("wl-sets") for _ in hists]
    coll = TE.MegaBatch()
    fins = [s.append_stage(h, collector=coll)
            for s, h in zip(sess, hists)]
    coll.flush()
    assert TE.DISPATCHES - d0 == 1 and TE.MEGABATCHES - m0 == 1
    for s, fin, (so, sfr) in zip(sess, fins, solo):
        fo = fin()
        assert fo == so
        assert torch.equal(s._fr, sfr)
        s.close()


def test_sets_checkpoint_restore():
    h = TW.sets_batch(30, 1)[0]
    s = _session("wl-sets")
    s.append(h[:20])
    ck = s.checkpoint()
    s2 = TSW.restore_session(ck, device="cpu")
    assert s2._ids == s._ids
    s.append(h[20:])
    s2.append(h[20:])
    assert s.close() == s2.close()


def test_wl_launch_error_raises_and_latches(monkeypatch):
    hists, model = TW.bank_batch(23, 1)

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(TB, "wl_bank_delta", boom)
    s = _session("wl-bank", model)
    with pytest.raises(RuntimeError, match="device lost"):
        s.append(hists[0])
    assert s.poll()["valid"] == "unknown"


# --- manager integration ---------------------------------------------------------

def test_manager_open_evict_restore_close():
    mgr = SessionManager(max_sessions=4, idle_s=10.0, device="cpu")
    hists, model = TW.bank_batch(40, 1)
    sid, s = mgr.open(0.0, model="wl-bank", wl=model)
    s.append(hists[0][:6])
    assert mgr.carry_bytes() > 0
    mgr.evict_idle(100.0)
    assert len(mgr) == 0 and mgr.checkpoint_count() == 1
    s2 = mgr.get(sid, 101.0)
    assert s2 is not None and s2.family == "bank"
    s2.append(hists[0][6:])
    out = mgr.close(sid)
    assert out["valid"] is True, out


def test_bad_model_params():
    with pytest.raises(ValueError):
        _session("wl-bank")
    with pytest.raises(ValueError):
        _session("wl-nope")
