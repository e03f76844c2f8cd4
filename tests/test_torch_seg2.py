"""The port's seg2 capacity engine and packing helpers against the JAX
package.

``check_device_seg2``, ``check_device_seg2_chunk`` (with in-place
escalation through ``expand_seg_carry`` mid-stream), the ``PackPlan``
helpers, the pending-count telemetry and the per-op step stream, on the
same seeded histories. Every output is an integer: parity is exact
(bit-equal int32). A carry's frontier is compared as the set of its
valid configs — rows past the valid prefix are don't-care in both
packages.
"""

import random

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import mxu as TMX
from comdb2_tpu_torch.utils import resolve_device


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch ops here are tiny; one intra-op thread keeps them
    off a busy host's thread pool. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, n_procs, max_pending, mutate=False, n_events=240):
    rng = random.Random(seed)
    h = JS.register_history(rng, n_procs=n_procs, n_events=n_events,
                            values=3, p_info=0.0, max_pending=max_pending)
    if mutate:
        h = JS.mutate(rng, h)
    packed = jax_pack(h)
    mm = jax_memo(JM.cas_register(), packed)
    segs = LJ.make_segments(packed, s_pad=256, k_pad=8)
    segs, p_eff = LJ.remap_slots(segs)
    P = max(p_eff + (p_eff & 1), 2)
    succ = LJ.pad_succ(mm.succ, 8, 16)
    sizes = dict(n_states=mm.n_states, n_transitions=mm.n_transitions)
    return packed, mm, segs, succ, P, sizes


def _configs(carry, P):
    st = np.asarray(carry[0])
    sl = np.asarray(carry[1])
    va = np.asarray(carry[2])
    return {(int(st[i]), tuple(int(x) for x in sl[i][:P]))
            for i in np.flatnonzero(va)}


def _tconfigs(carry, P):
    return _configs(tuple(c.numpy() if isinstance(c, torch.Tensor) else c
                          for c in carry[:3]), P)


CASES = [(4100, 6, 4, False), (4101, 8, 6, True), (4102, 6, 6, False),
         (4103, 4, None, True)]


@pytest.mark.parametrize("F", [128, 256, 8192])
@pytest.mark.parametrize("case", CASES)
def test_check_device_seg2_matches(case, F):
    seed, n_procs, mp, mut = case
    _, _, segs, succ, P, sizes = _case(seed, n_procs, mp, mut)
    args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    want = LJ.check_device_seg2(*args, F=F, Fs=32, P=P, **sizes)
    got = LT.check_device_seg2(*args, F=F, Fs=32, P=P, device="cpu",
                               **sizes)
    assert got == tuple(int(x) for x in want)


def test_seg2_without_pack_plan_and_without_small_tier():
    """The full-row lexsort (no memo sizes) and the big-only engine
    (Fs >= F) agree with the JAX package too."""
    _, _, segs, succ, P, sizes = _case(4104, 6, 5, True)
    args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    for kw in (dict(F=128, Fs=32), dict(F=64, Fs=64)):
        want = LJ.check_device_seg2(*args, P=P, **kw)
        got = LT.check_device_seg2(*args, P=P, device="cpu", **kw)
        assert got == tuple(int(x) for x in want)


def test_chunked_escalation_matches_chunk_by_chunk():
    """The driver's chunked form with in-place escalation: every chunk
    carry (status, fail, n, frontier set) equals the JAX package's, and
    the escalation fires mid-stream."""
    _, _, segs, succ, P, sizes = _case(4118, 6, 4)
    S = segs.ok_proc.shape[0]
    chunk = 16
    ladder = [16, 128, 1024]
    ix = 0
    cj = LJ.init_seg_carry(ladder[0], P)
    ct = LT.init_seg_carry(ladder[0], P, "cpu")
    done = 0
    escalated_at = []
    while done < S:
        part = tuple(a[done:done + chunk] for a in
                     (segs.inv_proc, segs.inv_tr, segs.ok_proc,
                      segs.depth))
        F = ladder[ix]
        nj = LJ.check_device_seg2_chunk(succ, *part, done, cj, F=F,
                                        Fs=32, P=P, **sizes)
        nt = LT.check_device_seg2_chunk(succ, *part, done, ct, F=F,
                                        Fs=32, P=P, device="cpu",
                                        **sizes)
        assert (nt[4], nt[5]) == (int(nj[4]), int(nj[5]))
        if nt[4] == LT.UNKNOWN and ix + 1 < len(ladder):
            ix += 1
            cj = LJ.expand_seg_carry(cj, ladder[ix])
            ct = LT.expand_seg_carry(ct, ladder[ix])
            assert _tconfigs(ct, P) == _configs(cj, P)
            assert ct[0].shape[0] == np.asarray(cj[0]).shape[0]
            escalated_at.append(done)
            continue
        assert nt[3] == int(nj[3])
        assert _tconfigs(nt, P) == _configs(nj, P)
        cj, ct = nj, nt
        done += chunk
        if nt[4] != LT.VALID:
            break
    assert escalated_at and escalated_at[0] > 0
    assert ct[4] == LT.VALID


def test_expand_seg_carry_pads_like_the_jax_package():
    cj = LJ.init_seg_carry(16, 6)
    ct = LT.init_seg_carry(16, 6, "cpu")
    ej = LJ.expand_seg_carry(cj, 64)
    et = LT.expand_seg_carry(ct, 64)
    for a, b in zip(et[:3], ej[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert et[3:] == tuple(int(x) for x in ej[3:])
    with pytest.raises(ValueError):
        LT.expand_seg_carry(et, 16)


@pytest.mark.parametrize("init", [
    lambda: LT.init_seg_carry(16, 6)[0],
    lambda: TMX.init_carry(1, 1024, 16, n_states=6, n_transitions=26)[1]],
    ids=["linear_torch.init_seg_carry", "mxu.init_carry"])
def test_carry_constructors_default_to_the_card(init):
    """With no device, a carry goes where every entry point goes:
    ``resolve_device()`` — the card, or on a host without one the same
    error ``resolve_device()`` raises."""
    try:
        want = resolve_device()
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            init()
        assert str(got.value) == str(e)
        return
    assert init().device.type == want.type


@pytest.mark.parametrize("n_states,n_transitions,P", [
    (6, 26, 6), (6, 26, 10), (130, 200, 18), (2, 2, 1), (5, 9, 20),
    (40, 1 << 20, 4), (1 << 30, 3, 2)])
def test_pack_plans_match(n_states, n_transitions, P):
    assert LT.make_pack_plan(n_states, n_transitions, P) == \
        LJ.make_pack_plan(n_states, n_transitions, P)
    assert LT.pack_bits(n_states, n_transitions, P) == \
        LJ.pack_bits(n_states, n_transitions, P)
    widths = [5] + [7] * P
    assert LT._greedy_split(widths) == LJ._greedy_split(widths)


def test_pack_plan_words_and_pending_histogram_match():
    rng = np.random.default_rng(3)
    F, P = 64, 10
    states = rng.integers(0, 6, F).astype(np.int32)
    slots = rng.integers(-2, 26, (F, P)).astype(np.int32)
    valid = rng.random(F) < 0.7
    plan = LT.make_pack_plan(6, 26, P)
    got = LT._pack_plan_words(torch.from_numpy(states),
                              torch.from_numpy(slots), plan)
    want = LJ._pack_plan_words(states, slots, LJ.make_pack_plan(6, 26, P))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    h = LT.pending_histogram(torch.from_numpy(slots),
                             torch.from_numpy(valid), P=P)
    hj = np.asarray(LJ.pending_histogram(slots, valid, P=P))
    assert h.tolist() == hj.tolist()
    assert LT.estimated_cost_hist(h.tolist()) == \
        LJ.estimated_cost_hist(hj.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_make_stream_matches(seed):
    rng = random.Random(4200 + seed)
    h = JS.register_history(rng, n_procs=5, n_events=120, p_info=0.1)
    packed = jax_pack(h)
    for n_pad in (None, 256):
        a = LJ.make_stream(packed, n_pad=n_pad)
        b = LT.make_stream(packed, n_pad=n_pad)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
