"""The port's segment-search kernel module against the JAX package.

- Its plain PyTorch version (``seg_search_reference``, what the wrapper
  runs for CPU tensors) against the TPU kernel itself, run in Pallas
  interpret mode, on one 2-word (P <= 7) and one 3-word (P 8..15) spec.
- The same against the XLA segment engine ``check_device_seg2`` at
  F=128 over seeded valid, INVALID and overflowing (UNKNOWN) histories.
(The CUDA kernel against the plain version on the card is in
``test_torch_cuda.py``.)

Every output is an integer: parity is exact. ``n`` is compared on VALID
and INVALID only — on UNKNOWN it depends on which 128 configs survived
the overflow.
"""

import random

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.checker import pallas_seg as PS
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu_torch import convert
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.utils import compile_guard as CG


@pytest.fixture()
def interpret_kernel():
    PS.use_interpret(True)
    yield
    PS.use_interpret(False)


def _port(succ, segs, **kw):
    """The port's kernel entry on CPU tensors (its plain version), fed
    the JAX package's numpy arrays through ``convert``."""
    return SK.check_device_seg_kernel(
        convert.succ_tensor(succ, "cpu").numpy(),
        convert.segment_stream(segs), device="cpu", **kw)


def _same(port, ref):
    assert port[:2] == tuple(int(x) for x in ref[:2]), (port, ref)
    if port[0] != SK.UNKNOWN:
        assert port[2] == int(ref[2]), (port, ref)


def test_spec_gate_and_layout_match_the_jax_package():
    for args in [(8, 32, 7, 4), (64, 64, 2, 4), (8, 32, 10, 4),
                 (8, 32, 16, 4), (128, 64, 2, 4), (256, 64, 2, 4),
                 (2, 2, 1, 9), (2, 4094, 15, 4), (8, 1 << 27, 1, 4),
                 (6, 36, 6, 2), (6, 36, 10, 8), (1, 1, 1, 1)]:
        j, t = PS.spec_for(*args), SK.spec_for(*args)
        assert (j is None) == (t is None), args
        if j is not None:
            assert (j.P, j.K, j.slot_bits, j.state_bits, j.slot_pos,
                     j.state_pos, j.rows, j.n_words) == \
                (t.P, t.K, t.slot_bits, t.state_bits, t.slot_pos,
                 t.state_pos, t.rows, t.n_words), args
            root = PS.initial_frontier(j)
            np.testing.assert_array_equal(
                convert.frontier_words(root, "cpu").numpy(),
                SK.initial_frontier(t))


def _interpret_case(histories, n_states, n_transitions, P, k_pad):
    for h in histories:
        packed = jax_pack(h)
        mm = jax_memo(JM.cas_register(), packed)
        assert mm.n_states <= n_states
        assert mm.n_transitions <= n_transitions
        succ = LJ.pad_succ(mm.succ, n_states, n_transitions)
        segs = LJ.make_segments(packed, s_pad=64, k_pad=k_pad)
        sizes = dict(n_states=n_states, n_transitions=n_transitions, P=P)
        ref = PS.check_device_pallas(succ, segs, **sizes)
        assert ref is not None
        _same(_port(succ, segs, **sizes), ref)


def test_plain_matches_interpret_kernel_two_words(interpret_kernel):
    rng = random.Random(909)
    hs = [JS.register_history(rng, n_procs=4, n_events=40, values=3,
                              p_info=0.0) for _ in range(4)]
    hs.append(JS.mutate(rng, hs[0]))
    spec = SK.spec_for(8, 16, 6, 4)
    assert (spec.rows, spec.n_words) == (8, 2)
    _interpret_case(hs, 8, 16, 6, 4)


def test_plain_matches_interpret_kernel_three_words(interpret_kernel):
    rng = random.Random(777)
    base = JS.register_history(rng, n_procs=10, n_events=60, values=3,
                               p_info=0.0, max_pending=4)
    hs = [base, JS.mutate(rng, base),
          JS.register_history(rng, n_procs=10, n_events=60, values=3,
                              p_info=0.0, max_pending=8)]
    spec = SK.spec_for(8, 32, 10, 8)
    assert (spec.rows, spec.n_words) == (16, 3)
    _interpret_case(hs, 8, 32, 10, 8)


def _seg2_histories():
    out = []
    for seed in range(20):
        rng = random.Random(4000 + seed)
        h = JS.register_history(
            rng, n_procs=rng.choice([4, 6, 8]),
            n_events=rng.choice([80, 200, 400]), values=3, p_info=0.0,
            max_pending=rng.choice([3, 4, 6]))
        if seed % 3 == 1:
            h = JS.mutate(rng, h)
        out.append(h)
    return out


def test_plain_matches_xla_seg2_at_f128():
    seen = set()
    for h in _seg2_histories():
        packed = jax_pack(h)
        mm = jax_memo(JM.cas_register(), packed)
        segs = LJ.make_segments(packed, s_pad=256, k_pad=8)
        segs, p_eff = LJ.remap_slots(segs)
        assert p_eff <= 6
        succ = LJ.pad_succ(mm.succ, 8, 16)
        sizes = dict(n_states=8, n_transitions=16)
        ref = LJ.check_device_seg2(
            succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth,
            F=SK.F, Fs=32, P=6, **sizes)
        port = _port(succ, segs, P=6, **sizes)
        _same(port, ref)
        seen.add(port[0])
    assert seen == {SK.VALID, SK.INVALID, SK.UNKNOWN}


def test_reference_contract_on_a_chunk_boundary():
    """Running a stream in two pieces through the carry gives the same
    result and the same frontier as one piece."""
    rng = random.Random(5)
    h = JS.register_history(rng, n_procs=5, n_events=300, values=3,
                            p_info=0.0, max_pending=4)
    packed = jax_pack(h)
    mm = jax_memo(JM.cas_register(), packed)
    segs, p = LJ.remap_slots(LJ.make_segments(packed, k_pad=4))
    spec = SK.spec_for(mm.n_states, mm.n_transitions, p, 4)
    seg = torch.from_numpy(SK.pack_segments(segs, spec))
    ws = torch.from_numpy(SK.initial_frontier(spec))
    stat = torch.from_numpy(SK._init_stat())
    table = torch.from_numpy(SK.pack_table(mm.succ))
    T = mm.n_transitions
    launches = CG.LAUNCHES["seg_search"]
    one = SK.seg_search(seg, 0, T, ws, stat, table, spec)
    half = seg.shape[0] // 2
    st, fa, n, ws1 = SK.seg_search(seg[:half], 0, T, ws, stat, table,
                                   spec)
    two = SK.seg_search(seg[half:], half, T, ws1,
                        torch.tensor([st, fa, n, -1], dtype=torch.int32),
                        table, spec)
    assert one[:3] == two[:3]
    assert SK.decode_frontier(spec, one[3], p) == \
        SK.decode_frontier(spec, two[3], p)
    assert CG.LAUNCHES["seg_search"] == launches   # CPU tensors never launch


def test_wrapper_rejects_bad_inputs():
    spec = SK.spec_for(8, 16, 6, 2)
    assert spec.n_words == 2
    seg = torch.zeros((3, 6), dtype=torch.int32)
    ws = torch.from_numpy(SK.initial_frontier(spec))
    stat = torch.from_numpy(SK._init_stat())
    table = torch.zeros(16, dtype=torch.int32)
    SK._check_inputs(seg, ws, stat, table, spec)
    with pytest.raises(TypeError):
        SK._check_inputs(seg.long(), ws, stat, table, spec)
    with pytest.raises(ValueError):
        SK._check_inputs(seg[:, :5], ws, stat, table, spec)
    with pytest.raises(ValueError):
        SK._check_inputs(seg, ws, stat, torch.zeros(9000,
                                                    dtype=torch.int32),
                         spec)
    with pytest.raises(ValueError):
        SK._check_inputs(seg, torch.zeros((2, 256), dtype=torch.int32)
                         [:, ::2], stat, table, spec)
