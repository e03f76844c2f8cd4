"""The port's MXU frontier engine (``checker/mxu.py``) and columnar
wide-P generator against the JAX package.

``check_device_mxu``, ``check_device_mxu_chunk`` (in-place escalation
through ``expand_carry``) and ``check_device_mxu_batch`` on small wide
histories (P = 16, n_free <= 4) and their violation twins; the
``fits`` / ``serves`` / ``bucket_F`` policy tables; and ``analysis``
routing wide P to the engine. Every output is an integer: parity is
exact (bit-equal int32).
"""

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import analysis as jax_analysis
from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.checker import mxu as JMX
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth_columnar as JSC
from comdb2_tpu.utils import next_pow2

from comdb2_tpu_torch.checker import analysis
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import mxu as TMX
from comdb2_tpu_torch.checker.linear import REFERENCE_ENGINES
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import synth_columnar as TSC


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch ops here are tiny; one intra-op thread keeps them
    off a busy host's thread pool. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prep(p, s_pad=32, k_pad=4):
    mm = jax_memo(JM.cas_register(), p)
    segs = LJ.make_segments(p, s_pad=s_pad, k_pad=k_pad)
    segs, p_eff = LJ.remap_slots(segs)
    succ = LJ.pad_succ(mm.succ, next_pow2(mm.n_states),
                       next_pow2(mm.n_transitions))
    sizes = dict(n_states=mm.n_states, n_transitions=mm.n_transitions)
    return mm, segs, succ, max(p_eff, 1), sizes


def _wide(seed, n_hist=1, violation=False, n_waves=2, n_chain=12,
          n_free=4, gen=JSC):
    """The same wide histories from either package's generator (each
    package's entry points take its own PackedHistory)."""
    return gen.wide_register_batch_packed(
        seed, n_hist, n_waves=n_waves, n_chain=n_chain, n_free=n_free,
        values=16, violation=violation)


@pytest.mark.parametrize("violation", [False, True])
def test_wide_generator_matches_array_for_array(violation):
    kw = dict(n_waves=2, n_chain=12, n_free=4, values=16,
              violation=violation)
    a = JSC.wide_register_batch_columns(31, 3, **kw)
    b = TSC.wide_register_batch_columns(31, 3, **kw)
    for x, y in zip(a[:-1], b[:-1]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.values == b.values


def test_register_generator_and_packer_match():
    a = JSC.register_batch_packed(11, 3, 60, n_procs=5, values=5,
                                  p_info=0.1)
    b = TSC.register_batch_packed(11, 3, 60, n_procs=5, values=5,
                                  p_info=0.1)
    for pa, pb in zip(a, b):
        for f in ("process", "type", "f", "value", "trans", "pair",
                  "fails", "time"):
            x, y = getattr(pa, f), getattr(pb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        for f in ("process_table", "f_table", "value_table",
                  "transition_table"):
            assert getattr(pa, f) == getattr(pb, f), f


@pytest.mark.parametrize("violation", [False, True])
@pytest.mark.parametrize("F", [64, 1024])
def test_check_device_mxu_matches(violation, F):
    for p in _wide(31, n_hist=2, violation=violation):
        mm, segs, succ, P, sizes = _prep(p)
        assert P == 16
        args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc,
                segs.depth)
        want = JMX.check_device_mxu(*args, F=F, P=P, **sizes)
        got = TMX.check_device_mxu(*args, F=F, P=P, device="cpu",
                                   **sizes)
        assert got == tuple(int(x) for x in want)
        if F == 1024:
            assert got[0] == (LT.INVALID if violation else LT.VALID)


def test_check_device_mxu_batch_matches():
    import comdb2_tpu.checker.batch as JB
    from comdb2_tpu_torch.checker import batch as TB

    jb = JB.pack_batch(_wide(67, n_hist=3) + _wide(67, violation=True),
                       JM.cas_register())
    tb = TB.pack_batch(_wide(67, n_hist=3, gen=TSC)
                       + _wide(67, violation=True, gen=TSC),
                       TM.cas_register())
    sb = JB.segment_batch(jb)
    P = next_pow2(jb.P, 2)
    succ = LJ.pad_succ(jb.memo.succ, next_pow2(jb.memo.n_states),
                       next_pow2(jb.memo.n_transitions))
    sizes = dict(n_states=jb.memo.n_states,
                 n_transitions=jb.memo.n_transitions)
    args = (succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth)
    want = JMX.check_device_mxu_batch(*args, B=4, F=1024, P=P, **sizes)
    got = TMX.check_device_mxu_batch(*args, B=4, F=1024, P=P,
                                     device="cpu", **sizes)
    for a, b in zip(got, want):
        assert a.tolist() == np.asarray(b).tolist()
    assert got[0].tolist() == [LT.VALID] * 3 + [LT.INVALID]
    # and check_batch picks the engine for this wide batch
    info = {}
    st, fa, n = TB.check_batch(tb, F=1024, device="cpu", info=info)
    jst, jfa, jn = JB.check_batch(jb, F=1024)
    assert info["engine"] == "mxu"
    assert (st.tolist(), fa.tolist(), n.tolist()) == \
        (jst.tolist(), jfa.tolist(), jn.tolist())


def test_chunked_expand_carry_escalates_in_place():
    """F=64 overflows, ``expand_carry(1024)`` widens the pre-chunk carry
    and re-runs only that chunk; every chunk carry equals the JAX
    package's."""
    mm, segs, succ, P, sizes = _prep(
        _wide(47, n_chain=7, n_free=9)[0], s_pad=64)
    S = segs.ok_proc.shape[0]
    chunk, F = 32, 64
    cj = JMX.init_carry(1, F, P, **sizes)
    ct = TMX.init_carry(1, F, P, device="cpu", **sizes)
    done = 0
    escalated = False
    while done < S:
        part = tuple(a[done:done + chunk] for a in
                     (segs.inv_proc, segs.inv_tr, segs.ok_proc,
                      segs.depth))
        nj = JMX.check_device_mxu_chunk(succ, *part, done, cj, F=F, P=P,
                                        **sizes)
        nt = TMX.check_device_mxu_chunk(succ, *part, done, ct, F=F, P=P,
                                        device="cpu", **sizes)
        for a, b in zip(nt[1:], nj[1:]):
            assert a.tolist() == np.asarray(b).tolist()
        for a, b in zip(nt[0], nj[0]):
            assert a.tolist() == np.asarray(b).tolist()
        if int(nt[3][0]) == LT.UNKNOWN and F < 1024:
            F = 1024
            cj = JMX.expand_carry(cj, F)
            ct = TMX.expand_carry(ct, F)
            for a, b in zip(ct[0], cj[0]):
                assert a.tolist() == np.asarray(b).tolist()
            escalated = True
            continue
        cj, ct = nj, nt
        done += chunk
        if int(ct[3][0]) != LT.VALID:
            break
    assert escalated
    assert int(ct[3][0]) == LT.VALID
    h = TMX.pending_histogram(ct[0], ct[1], P=P, **sizes)
    hj = JMX.pending_histogram(cj[0], cj[1], P=P, **sizes)
    assert h.tolist() == np.asarray(hj).tolist()


@pytest.mark.parametrize("n_states,n_transitions,P", [
    (5, 9, 16), (5, 9, 15), (5, 9, 33), (5, 9, 32), (300, 9, 18),
    (5, 200, 18), (256, 128, 20), (1 << 30, 9, 16)])
def test_policy_tables_match(n_states, n_transitions, P, monkeypatch):
    for flag in ("1", "0"):
        monkeypatch.setenv("COMDB2_TPU_MXU", flag)
        assert TMX.fits(n_states, n_transitions, P) == \
            JMX.fits(n_states, n_transitions, P)
        assert TMX.serves(n_states, n_transitions, P) == \
            JMX.serves(n_states, n_transitions, P)
    for F in (1, 256, 1024, 1025, 8192, 65536, 131072, 1 << 20):
        assert TMX.bucket_F(F) == JMX.bucket_F(F)
    assert (TMX.MIN_P, TMX.MAX_P, TMX.S_CAP, TMX.T_CAP, TMX.CAPACITIES,
            TMX.CHUNK) == (JMX.MIN_P, JMX.MAX_P, JMX.S_CAP, JMX.T_CAP,
                           JMX.CAPACITIES, JMX.CHUNK)


@pytest.mark.parametrize("violation", [False, True])
def test_analysis_routes_wide_p_like_the_jax_package(violation):
    kw = dict(n_chain=13, n_free=3, violation=violation)
    a = jax_analysis(JM.cas_register(), _wide(53, **kw)[0],
                     backend="device")
    b = analysis(TM.cas_register(), _wide(53, gen=TSC, **kw)[0],
                 backend="device", device="cpu")
    assert b.info["engine"] == REFERENCE_ENGINES[a.info["engine"]] \
        == "mxu-frontier"
    assert (b.valid, b.op_index, b.final_count) == \
        (a.valid, a.op_index, a.final_count)
    assert b.info["frontier_capacity"] == a.info["frontier_capacity"]
    assert b.info.get("paths") == a.info.get("paths")
    assert b.valid is (not violation)


def test_analysis_chunked_progress_matches():
    kw = dict(n_waves=3, n_chain=14, n_free=2)
    calls = []
    a = jax_analysis(JM.cas_register(), _wide(59, **kw)[0],
                     backend="device", progress=lambda *x: None,
                     progress_interval_s=0.0)
    b = analysis(TM.cas_register(), _wide(59, gen=TSC, **kw)[0],
                 backend="device", device="cpu",
                 progress=lambda *x: calls.append(x),
                 progress_interval_s=0.0)
    assert b.info["engine"] == "mxu-frontier"
    assert (b.valid, b.final_count, b.info["frontier_capacity"]) == \
        (a.valid, a.final_count, a.info["frontier_capacity"])
    assert calls and set(calls[-1][3]) == {"visited_per_s", "segs_per_s",
                                           "est_cost"}
