"""The port's single-history check end to end against the JAX package:
the chunked kernel path (boundary frontier and ``done`` against the
TPU kernel's chunked scan in Pallas interpret mode), ``analysis``
verdicts, fail indices, engines and capacities, counterexample configs
and paths, and the filetest exit codes — including the two shapes past
the kernel: a gate-rejected wide history (the MXU frontier engine) and
a kernel overflow (the seg2 capacity ladder).

On this host the JAX package's fused kernel does not run (it is
unavailable on the CPU outside interpret mode), so its ladder starts at
the XLA engines; the port's starts at its kernel's plain version, whose
attempt is the first entry of ``engines_tried``."""

import random

import pytest
import torch

import comdb2_tpu.checker.linear_jax as LJ
from comdb2_tpu.checker import analysis as jax_analysis
from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu import filetest as jax_filetest
from comdb2_tpu.ops import op as JO

from comdb2_tpu_torch import convert, filetest
from comdb2_tpu_torch.checker import analysis
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.checker.linear import REFERENCE_ENGINES
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.history import history_to_edn


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


def _ladder_parity(a, b, kernel_tried):
    """Verdict, op index, mapped engine, capacity and ``engines_tried``
    of the port's ``b`` against the JAX package's ``a``."""
    assert (b.valid, b.op_index, b.final_count) == \
        (a.valid, a.op_index, a.final_count)
    assert b.info["engine"] == REFERENCE_ENGINES[a.info["engine"]]
    assert b.info["frontier_capacity"] == a.info["frontier_capacity"]
    mapped = [{"engine": REFERENCE_ENGINES[t["engine"]],
               "frontier_capacity": t["frontier_capacity"]}
              for t in a.info.get("engines_tried", [])]
    first = ([{"engine": "seg-reference", "frontier_capacity": SK.F}]
             if kernel_tried else [])
    assert b.info.get("engines_tried", []) == first + mapped
    assert b.configs == a.configs
    assert b.info.get("paths") == a.info.get("paths")


def test_overflow_is_unknown_with_the_attempt_recorded():
    """A kernel overflow escalates through the seg2 capacity ladder: the
    Random(77) history is VALID at capacity 8192 in both packages, and
    the kernel's attempt at 128 is recorded first."""
    h = JS.register_history(random.Random(77), n_procs=10, n_events=600,
                            values=5, p_info=0.0, max_pending=10)
    a = jax_analysis(JM.cas_register(), h, backend="device")
    b = analysis(TM.cas_register(), h, backend="device", device="cpu")
    _ladder_parity(a, b, kernel_tried=True)
    assert b.valid is True and b.info["engine"] == "torch-seg2"
    assert b.info["frontier_capacity"] == 8192


def _wide_parity(with_reads):
    h = JS.pinned_wide_history(18, with_reads=with_reads)
    a = jax_analysis(JM.cas_register(), h, backend="device")
    b = analysis(TM.cas_register(),
                 TS.pinned_wide_history(18, with_reads=with_reads),
                 backend="device", device="cpu")
    _ladder_parity(a, b, kernel_tried=False)
    assert b.info["engine"] == "mxu-frontier" and b.valid is True
    assert b.info["effective_slots"] == 19


def test_shape_outside_the_kernel_gate_raises():
    """19 open slots: past the kernel's gate, so no kernel attempt; the
    MXU frontier engine decides, as in the JAX package."""
    _wide_parity(with_reads=False)


def test_shape_outside_the_kernel_gate_with_reads():
    """The same 19 open slots with reads in flight: the MXU engine
    decides, as in the JAX package."""
    _wide_parity(with_reads=True)


def test_wide_invalid_counterexample_through_the_seg2_rescan():
    """A P > 15 INVALID history: the kernel cannot re-scan it, so the
    counterexample comes from the seg2 engine's chunked re-scan, with
    the reference's op index and paths."""
    h = JS.mutate(random.Random(5), JS.pinned_wide_history(18))
    a = jax_analysis(JM.cas_register(), h, backend="device")
    b = analysis(TM.cas_register(), h, backend="device", device="cpu")
    _ladder_parity(a, b, kernel_tried=False)
    assert b.valid is False and b.info["paths"] and b.configs


def _past_every_rung(O):
    """UNKNOWN in both packages: 130 distinct writes put the memo table
    past the kernel's gate and the MXU engine's caps, then 17 reads of
    one write in flight together fork 2^17 configs, past the seg2
    ladder's top capacity of 65536."""
    h = []
    for v in range(130):
        h += [O.invoke(0, "write", v), O.ok(0, "write", v)]
    h.append(O.invoke(0, "write", 500))
    h += [O.invoke(p, "read", None) for p in range(1, 18)]
    h.append(O.ok(0, "write", 500))
    h += [O.ok(p, "read", 500) for p in range(1, 18)]
    return h


@pytest.mark.parametrize("kind,want", [("valid", 0), ("invalid", 1),
                                       ("unknown", 2)])
def test_filetest_exit_codes(tmp_path, kind, want):
    """The port's filetest and the JAX package's agree on the exit
    code of the same EDN file."""
    if kind == "valid":
        h = JS.register_history(random.Random(1), n_procs=4,
                                n_events=300, p_info=0.0)
    elif kind == "invalid":
        h = _invalid(92, n_procs=4, n_events=300, values=3, p_info=0.0)
    else:
        h = _past_every_rung(JO)
    p = tmp_path / "h.edn"
    p.write_text(history_to_edn(h))
    assert filetest.main([str(p), "--device", "cpu"]) == want
    assert jax_filetest.main([str(p)]) == want
