"""The port's single-history check end to end against the JAX package:
the chunked kernel path (boundary frontier and ``done`` against the
TPU kernel's chunked scan in Pallas interpret mode), ``analysis``
verdicts, fail indices, counterexample configs and paths, the filetest
exit codes, and the two gaps that are not ported yet (gate-rejected
shapes raise, overflow is UNKNOWN with the attempt recorded)."""

import random

import pytest

import comdb2_tpu.checker.linear_jax as LJ
from comdb2_tpu.checker import analysis as jax_analysis
from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu_torch import convert, filetest
from comdb2_tpu_torch.checker import EngineNotPorted, analysis
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops.history import history_to_edn


@pytest.fixture()
def interpret_kernel():
    PS.use_interpret(True)
    yield
    PS.use_interpret(False)


def _invalid(seed, **kw):
    rng = random.Random(seed)
    for _ in range(50):
        h = JS.mutate(rng, JS.register_history(rng, **kw))
        packed = jax_pack(h)
        from comdb2_tpu.checker import linear_host

        r = linear_host.check(jax_memo(JM.cas_register(), packed), packed,
                              max_configs=1 << 16)
        if not r.valid:
            return h
    raise AssertionError("no invalid mutation")


def test_chunked_boundary_matches_interpret_kernel(interpret_kernel):
    rng = random.Random(31)
    hs = [JS.register_history(rng, n_procs=4, n_events=120, values=3,
                              p_info=0.0),
          _invalid(32, n_procs=4, n_events=120, values=3, p_info=0.0),
          _invalid(33, n_procs=5, n_events=160, values=3, p_info=0.0)]
    sizes = dict(n_states=8, n_transitions=16, P=6)
    spec_j = PS.spec_for(8, 16, 6, 4)
    spec_t = SK.spec_for(8, 16, 6, 4)
    assert spec_j.chunk == PS.CHUNK_INTERPRET == 16
    outcomes = set()
    for h in hs:
        packed = jax_pack(h)
        mm = jax_memo(JM.cas_register(), packed)
        succ = LJ.pad_succ(mm.succ, 8, 16)
        segs = LJ.make_segments(packed, s_pad=128, k_pad=4)
        ref = PS.check_device_pallas_chunked(succ, segs,
                                             return_boundary=True,
                                             **sizes)
        got = SK.check_device_seg_kernel_chunked(
            succ, convert.segment_stream(segs), return_boundary=True,
            chunk=16, device="cpu", **sizes)
        assert got[:2] == ref[:2]
        if got[0] != SK.UNKNOWN:
            assert got[2] == ref[2]
        (ws_j, done_j), (ws_t, done_t) = ref[3], got[3]
        assert done_t == done_j
        assert SK.decode_frontier(spec_t, ws_t, 6) == \
            PS.decode_frontier(spec_j, ws_j, 6)
        # the JAX frontier carried across decodes the same in the port
        assert SK.decode_frontier(
            spec_t, convert.frontier_words(ws_j, "cpu"), 6) == \
            PS.decode_frontier(spec_j, ws_j, 6)
        outcomes.add(got[0])
    assert outcomes == {SK.VALID, SK.INVALID}


def _compare(h, **kw):
    a = jax_analysis(JM.cas_register(), h, backend="device")
    b = analysis(TM.cas_register(), h, backend="device", device="cpu",
                 **kw)
    assert a.valid == b.valid
    assert a.op_index == b.op_index
    if a.valid is True:
        assert a.final_count == b.final_count
    assert a.configs == b.configs
    assert a.info.get("paths") == b.info.get("paths")
    assert a.info["effective_slots"] == b.info["effective_slots"]
    return b


@pytest.mark.parametrize("seed", range(6))
def test_analysis_matches_the_jax_package(seed):
    rng = random.Random(70 + seed)
    kw = dict(n_procs=rng.choice([3, 5, 8]), n_events=300, values=3,
              p_info=0.0, max_pending=3)
    h = (_invalid(700 + seed, **kw) if seed % 2
         else JS.register_history(rng, **kw))
    b = _compare(h)
    assert b.info["engine"] == "seg-reference"
    if seed % 2:
        assert b.valid is False and b.info.get("paths")
        assert b.configs
    else:
        assert b.valid is True


def test_analysis_with_progress_runs_chunked():
    h = JS.register_history(random.Random(90), n_procs=4, n_events=400,
                            values=3, p_info=0.0)
    calls = []
    b = _compare(h, progress=lambda *a: calls.append(a),
                 progress_interval_s=0.0)
    assert b.valid is True
    assert calls
    done, total, n, stats = calls[-1]
    assert done == total > 0 and n == b.final_count
    assert set(stats) == {"visited_per_s", "segs_per_s", "est_cost"}


def test_host_backend_matches():
    h = _invalid(91, n_procs=3, n_events=60, values=3, p_info=0.0)
    a = jax_analysis(JM.cas_register(), h)
    b = analysis(TM.cas_register(), h, device="cpu")
    assert a.info["backend"] == b.info["backend"] == "host"
    assert (a.valid, a.op_index, a.configs, a.info.get("paths")) == \
        (b.valid, b.op_index, b.configs, b.info.get("paths"))


def test_overflow_is_unknown_with_the_attempt_recorded():
    h = JS.register_history(random.Random(77), n_procs=10, n_events=600,
                            values=5, p_info=0.0, max_pending=10)
    b = analysis(TM.cas_register(), h, backend="device", device="cpu")
    assert b.valid == "unknown"
    assert b.info["engines_tried"] == [
        {"engine": "seg-reference", "frontier_capacity": 128}]
    assert "frontier overflow" in b.info["cause"]
    # the JAX package's fused kernel gives up at the same op: its
    # XLA engine at F=128 stands in for it on this host
    packed = jax_pack(h)
    mm = jax_memo(JM.cas_register(), packed)
    segs = LJ.make_segments(packed, k_pad=8)
    segs, p = LJ.remap_slots(segs)
    st, fail, _ = LJ.check_device_seg2(
        LJ.pad_succ(mm.succ, 8, 64), segs.inv_proc, segs.inv_tr,
        segs.ok_proc, segs.depth, F=128, Fs=32, P=p,
        n_states=mm.n_states, n_transitions=mm.n_transitions)
    assert int(st) == LJ.UNKNOWN
    assert b.op_index == int(segs.seg_index[int(fail)])


def test_shape_outside_the_kernel_gate_raises():
    from comdb2_tpu.ops.synth import pinned_wide_history

    h = pinned_wide_history(18, with_reads=False)     # 19 open slots
    with pytest.raises(EngineNotPorted, match="does not serve"):
        analysis(TM.cas_register(), h, backend="device", device="cpu")


@pytest.mark.parametrize("kind,want", [("valid", 0), ("invalid", 1),
                                       ("unknown", 2)])
def test_filetest_exit_codes(tmp_path, kind, want):
    if kind == "valid":
        h = JS.register_history(random.Random(1), n_procs=4,
                                n_events=300, p_info=0.0)
    elif kind == "invalid":
        h = _invalid(92, n_procs=4, n_events=300, values=3, p_info=0.0)
    else:
        h = JS.register_history(random.Random(77), n_procs=10,
                                n_events=600, values=5, p_info=0.0,
                                max_pending=10)
    p = tmp_path / "h.edn"
    p.write_text(history_to_edn(h))
    assert filetest.main([str(p), "--device", "cpu"]) == want
