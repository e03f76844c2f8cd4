"""The port's last batch engines (``checker/linear_torch.py``) against
the JAX package's (``checker/linear_jax.py``), on CPU tensors.

- the per-op engine ``check_device`` and its batched form
  ``check_device_batch`` (the JAX package's ``vmap``), the big-only
  segmented engine ``check_device_seg`` / ``_chunk`` / ``_batch``,
  ``expand_seg_carry_slots``, ``flat_pack_bits`` and the flat engine
  ``check_device_flat``: the same inputs through both packages at the
  same frontier capacity F;
- the batch of lanes mixes VALID, mutated INVALID and overflowing
  histories, and at the smallest F most lanes overflow: the batched
  engines must freeze each lane at its own fixed point, overflow and
  bound, so every lane also equals its own single-history run;
- the engine picker of ``checker.batch`` against the JAX package's
  predicates (``mxu.serves``, ``KeyLayout.fits``, ``flat_pack_bits``);
- the kernels' build raises when there is no ``nvcc`` (no fallback).

Tolerance: exact. Status and fail index bit-equal; ``n_final`` equal on
VALID lanes (the JAX package's cross-engine contract: an INVALID or
UNKNOWN lane's count depends on where the engine stopped).
"""

import random

import numpy as np
import pytest
import torch

import comdb2_tpu.checker.batch as JB
from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.checker import mxu as JMXU
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import synth as JS

from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import mxu as TMXU
from comdb2_tpu_torch.kernels import build
from comdb2_tpu_torch.models import model as TM

F_CASES = [8, 32, 256]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager CPU torch ops here are tiny; one intra-op thread keeps them
    off a busy host's thread pool. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _histories():
    """Four-process valid and mutated histories (one with info ops, so
    a process retires and the slot count grows) and a six-process one
    with up to six calls in flight, which overflows small frontiers."""
    rng = random.Random(3)
    hs = []
    for i in range(6):
        h = JS.register_history(rng, n_procs=4, n_events=60, values=4,
                                p_info=0.05 if i == 4 else 0.0)
        hs.append(JS.mutate(rng, h, values=4) if i % 2 else h)
    hs.insert(3, JS.register_history(random.Random(0), n_procs=6,
                                     n_events=80, values=5, p_info=0.0,
                                     max_pending=6))
    return hs


class Lanes:
    """One batch packed by both packages, with the engines' inputs."""

    def __init__(self):
        hs = _histories()
        self.jb = JB.pack_batch(hs, JM.cas_register())
        self.tb = TB.pack_batch(hs, TM.cas_register())
        self.B = len(hs)
        self.P = max(2, 1 << (self.jb.P - 1).bit_length())
        self.sizes = dict(n_states=self.jb.memo.n_states,
                          n_transitions=self.jb.memo.n_transitions)
        self.succ = LJ.pad_succ(self.jb.memo.succ)
        self.sb = JB.segment_batch(self.jb)
        S = self.sb.ok_proc.shape[0]
        # per lane (B, S, K) and each lane's own depth, as the JAX
        # package's vmap of the segmented engine takes them
        self.ip = np.ascontiguousarray(self.sb.inv_proc.transpose(1, 0, 2))
        self.it = np.ascontiguousarray(self.sb.inv_tr.transpose(1, 0, 2))
        self.op = np.ascontiguousarray(self.sb.ok_proc.T)
        self.dp = np.stack([
            np.pad(LJ.make_segments(p).depth,
                   (0, S - LJ.make_segments(p).depth.shape[0]))
            for p in self.jb.packeds]).astype(np.int32)


@pytest.fixture(scope="module")
def lanes():
    return Lanes()


def _ints(xs):
    return [np.asarray(x).tolist() for x in xs]


def _assert_equal(got, want):
    """(status, fail, n) per lane: status and fail bit-equal, n on
    VALID lanes."""
    st, fa, n = _ints(got)
    ws, wf, wn = _ints(want)
    assert st == ws
    assert fa == wf
    assert [a for a, s in zip(n, st) if s == LT.VALID] == \
        [b for b, s in zip(wn, ws) if s == LJ.VALID]


def test_batch_has_every_kind_of_lane(lanes):
    """At F = 32 the batch holds VALID, INVALID and overflowing lanes."""
    st, _, _ = LJ.check_device_batch(
        lanes.succ, lanes.jb.kind, lanes.jb.proc, lanes.jb.tr, F=32,
        P=lanes.P, **lanes.sizes)
    assert {LJ.VALID, LJ.INVALID, LJ.UNKNOWN} <= set(np.asarray(st).tolist())


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_matches(lanes, F):
    for i in range(lanes.B):
        want = LJ.check_device(lanes.succ, lanes.jb.kind[i],
                               lanes.jb.proc[i], lanes.jb.tr[i], F=F,
                               P=lanes.P, **lanes.sizes)
        got = LT.check_device(lanes.succ, lanes.tb.kind[i],
                              lanes.tb.proc[i], lanes.tb.tr[i], F=F,
                              P=lanes.P, device="cpu", **lanes.sizes)
        _assert_equal([[g] for g in got], [[int(w)] for w in want])


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_without_table_sizes_matches(lanes, F):
    """No memo sizes: the full row lexsort instead of a PackPlan."""
    i = 3
    want = LJ.check_device(lanes.succ, lanes.jb.kind[i], lanes.jb.proc[i],
                           lanes.jb.tr[i], F=F, P=lanes.P)
    got = LT.check_device(lanes.succ, lanes.tb.kind[i], lanes.tb.proc[i],
                          lanes.tb.tr[i], F=F, P=lanes.P, device="cpu")
    _assert_equal([[g] for g in got], [[int(w)] for w in want])


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_batch_matches(lanes, F):
    want = LJ.check_device_batch(lanes.succ, lanes.jb.kind, lanes.jb.proc,
                                 lanes.jb.tr, F=F, P=lanes.P,
                                 **lanes.sizes)
    stats = {}
    got = LT.check_device_batch(lanes.succ, lanes.tb.kind, lanes.tb.proc,
                                lanes.tb.tr, F=F, P=lanes.P, device="cpu",
                                stats=stats, **lanes.sizes)
    _assert_equal(got, want)
    assert all(g.dtype == torch.int32 for g in got)
    assert stats["closure_iterations"] > 0
    assert stats["host_syncs"] >= stats["closure_iterations"] // lanes.B


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_batch_lanes_equal_their_solo_runs(lanes, F):
    """Each lane stops at its own fixed point, overflow and P+1 bound:
    the batched engine gives every lane exactly its solo result, n
    included, whatever the other lanes do."""
    got = _ints(LT.check_device_batch(
        lanes.succ, lanes.tb.kind, lanes.tb.proc, lanes.tb.tr, F=F,
        P=lanes.P, device="cpu", **lanes.sizes))
    for i in range(lanes.B):
        solo = LT.check_device(lanes.succ, lanes.tb.kind[i],
                               lanes.tb.proc[i], lanes.tb.tr[i], F=F,
                               P=lanes.P, device="cpu", **lanes.sizes)
        assert (got[0][i], got[1][i], got[2][i]) == solo


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_seg_matches(lanes, F):
    for i in range(lanes.B):
        args = (lanes.succ, lanes.ip[i], lanes.it[i], lanes.op[i],
                lanes.dp[i])
        want = LJ.check_device_seg(*args, F=F, P=lanes.P, **lanes.sizes)
        got = LT.check_device_seg(*args, F=F, P=lanes.P, device="cpu",
                                  **lanes.sizes)
        _assert_equal([[g] for g in got], [[int(w)] for w in want])


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_seg_batch_matches(lanes, F):
    args = (lanes.succ, lanes.ip, lanes.it, lanes.op, lanes.dp)
    want = LJ.check_device_seg_batch(*args, F=F, P=lanes.P, **lanes.sizes)
    got = LT.check_device_seg_batch(*args, F=F, P=lanes.P, device="cpu",
                                    **lanes.sizes)
    _assert_equal(got, want)
    # every lane, n included, as its solo run of the same engine
    for i in range(lanes.B):
        solo = LT.check_device_seg(lanes.succ, lanes.ip[i], lanes.it[i],
                                   lanes.op[i], lanes.dp[i], F=F,
                                   P=lanes.P, device="cpu", **lanes.sizes)
        assert tuple(int(g[i]) for g in got) == solo


def _valid_rows(carry):
    """A chunk carry's (status, fail, n) and its valid configs in row
    order (rows past the valid ones hold don't-care values)."""
    states, slots, valid, n, status, fail = (
        np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        for x in carry)
    v = valid.astype(bool)
    return ((int(status), int(fail), int(n)),
            states[v].tolist(), slots[v].tolist())


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_seg_chunk_matches(lanes, F):
    """Chunks of 4 segments threading the carry: every boundary carry
    holds the same valid configs in the same order."""
    i = 3
    S = lanes.op.shape[1]
    jc = LJ.init_seg_carry(F, lanes.P)
    tc = LT.init_seg_carry(F, lanes.P, "cpu")
    for off in range(0, S, 4):
        sl = slice(off, off + 4)
        args = (lanes.succ, lanes.ip[i, sl], lanes.it[i, sl],
                lanes.op[i, sl], lanes.dp[i, sl])
        jc = LJ.check_device_seg_chunk(*args, off, jc, F=F, P=lanes.P,
                                       **lanes.sizes)
        tc = LT.check_device_seg_chunk(*args, off, tc, F=F, P=lanes.P,
                                       device="cpu", **lanes.sizes)
        want, got = _valid_rows(jc), _valid_rows(tc)
        assert got[0][:2] == want[0][:2]
        if want[0][0] == LJ.VALID:
            assert got == want


@pytest.mark.parametrize("pad", [0, 1, 3])
def test_expand_seg_carry_slots_matches(lanes, pad):
    """Widen a mid-stream carry's slot axis in both packages (host
    numpy), then run the next chunk from it at the wider P."""
    i, F, cut = 0, 32, 6
    first = (lanes.succ, lanes.ip[i, :cut], lanes.it[i, :cut],
             lanes.op[i, :cut], lanes.dp[i, :cut])
    jc = LJ.check_device_seg_chunk(*first, 0, LJ.init_seg_carry(F, lanes.P),
                                   F=F, P=lanes.P, **lanes.sizes)
    tc = LT.check_device_seg_chunk(*first, 0,
                                   LT.init_seg_carry(F, lanes.P, "cpu"),
                                   F=F, P=lanes.P, device="cpu",
                                   **lanes.sizes)
    P2 = lanes.P + pad
    jw = LJ.expand_seg_carry_slots(jc, P2)
    tw = LT.expand_seg_carry_slots(tc, P2)
    assert all(isinstance(b, np.ndarray) for b in tw)
    assert [(np.asarray(a).shape, np.asarray(a).dtype) for a in jw] == \
        [(b.shape, b.dtype) for b in tw]
    assert _valid_rows(tw) == _valid_rows(jw)
    assert (tw[1][:, lanes.P:] == LT.IDLE).all()
    rest = (lanes.succ, lanes.ip[i, cut:], lanes.it[i, cut:],
            lanes.op[i, cut:], lanes.dp[i, cut:])
    jc = LJ.check_device_seg_chunk(*rest, cut, jw, F=F, P=P2,
                                   **lanes.sizes)
    tc = LT.check_device_seg_chunk(*rest, cut, tw, F=F, P=P2,
                                   device="cpu", **lanes.sizes)
    assert _valid_rows(tc) == _valid_rows(jc)


def test_expand_seg_carry_slots_refuses_to_narrow(lanes):
    carry = LT.init_seg_carry(8, lanes.P, "cpu")
    with pytest.raises(ValueError):
        LT.expand_seg_carry_slots(carry, lanes.P - 1)


@pytest.mark.parametrize("F", F_CASES)
def test_check_device_flat_matches(lanes, F):
    sb = lanes.sb
    args = (lanes.succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth)
    kw = dict(B=lanes.B, F=F, P=lanes.P, **lanes.sizes)
    assert LJ.flat_pack_bits(lanes.B, lanes.sizes["n_states"],
                             lanes.sizes["n_transitions"], lanes.P)[3]
    want = LJ.check_device_flat(*args, **kw)
    stats = {}
    got = LT.check_device_flat(*args, device="cpu", stats=stats, **kw)
    _assert_equal(got, want)
    # the lockstep closure keeps the JAX package's counts everywhere,
    # overflowed and INVALID lanes included
    assert _ints(got)[2] == _ints(want)[2]
    assert stats["closure_iterations"] > 0


def test_check_device_flat_refuses_a_budget_that_does_not_fit(lanes):
    """Both packages refuse with the same class and message."""
    sb = lanes.sb
    args = (lanes.succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth)
    kw = dict(B=lanes.B, F=8, P=16, n_states=1 << 20,
              n_transitions=1 << 12)
    with pytest.raises(AssertionError) as want:
        LJ.check_device_flat(*args, **kw)
    with pytest.raises(AssertionError) as got:
        LT.check_device_flat(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def _unfit_histories():
    """Three four-process histories with info ops: retired processes
    take the slot count to 10 (16 once rounded up), past both the flat
    budget and the 62-bit key layout."""
    rng = random.Random(2)
    return [JS.register_history(rng, n_procs=4, n_events=40, values=4,
                                p_info=0.2) for _ in range(3)]


@pytest.mark.parametrize("engine", ["flat", "keys"])
def test_a_layout_that_does_not_fit_raises_the_references_error(engine):
    """``check_batch`` forced to an engine whose layout does not fit:
    the JAX package asserts (``linear_jax.check_device_flat`` /
    ``check_device_keys``); the port raises the same ``AssertionError``
    with the same message, also under ``python -O``."""
    hs = _unfit_histories()
    jb = JB.pack_batch(hs, JM.cas_register())
    tb = TB.pack_batch(hs, TM.cas_register())
    assert jb.P == tb.P == 10
    with pytest.raises(AssertionError) as want:
        JB.check_batch(jb, F=64, engine=engine)
    with pytest.raises(AssertionError) as got:
        TB.check_batch(tb, F=64, engine=engine, device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    assert str(got.value)


def test_the_layout_errors_survive_python_O(tmp_path):
    """The port's two refusals are raised, not asserted: under
    ``python -O`` they still raise."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    code = (
        "import numpy as np\n"
        "from comdb2_tpu_torch.checker import linear_torch as LT\n"
        "z = np.zeros((1, 1, 1), np.int32)\n"
        "s = np.zeros((2, 2), np.int32)\n"
        "out = []\n"
        "for f in (LT.check_device_flat, LT.check_device_keys):\n"
        "    try:\n"
        "        f(s, z, z, z[0], z[0, 0], B=1, F=8, P=16,\n"
        "          n_states=1 << 20, n_transitions=1 << 12, device='cpu')\n"
        "    except AssertionError as e:\n"
        "        out.append(str(e))\n"
        "print(out)\n")
    r = subprocess.run([sys.executable, "-O", "-c", code],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path),
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(
        ["flat engine requires the packed-key budget to fit",
         "key layout must fit 62 bits"])


@pytest.mark.parametrize("P", [1, 2, 4, 5, 8, 9, 16])
def test_flat_pack_bits_matches(P):
    for B in (1, 2, 7, 64, 4096):
        for n_states in (1, 2, 9, 1000, 1 << 20):
            for n_transitions in (1, 35, 77, 1 << 12):
                args = (B, n_states, n_transitions, P)
                assert LT.flat_pack_bits(*args) == LJ.flat_pack_bits(*args)


def _reference_pick(b, n_states, n_transitions, P):
    """The JAX package's ``pick_xla_engine`` order, from its own
    predicates."""
    if JMXU.serves(n_states, n_transitions, P):
        return "mxu"
    if LJ.KeyLayout(b, n_states, n_transitions, P).fits:
        return "keys"
    if LJ.flat_pack_bits(b, n_states, n_transitions, P)[3]:
        return "flat"
    return "vmap"


PICK_P = [2, 4, 8, 16, 32]


def _pick_grid(P):
    for b in (1, 8, 512, 4096):
        for n_states in (2, 9, 33, 300, 5000):
            for n_transitions in (5, 35, 77, 300, 3000):
                yield b, n_states, n_transitions, P


@pytest.mark.parametrize("P", PICK_P)
def test_engine_picker_matches_the_reference_predicates(P):
    """A grid of batch widths and table sizes: the port picks the
    engine the JAX package's predicates pick."""
    for args in _pick_grid(P):
        assert TB.pick_engine(*args) == _reference_pick(*args), args
        assert TMXU.serves(*args[1:]) == JMXU.serves(*args[1:])
        assert LT.KeyLayout(*args).fits == LJ.KeyLayout(*args).fits


def test_engine_picker_grid_never_picks_flat():
    """The flat key budget is the keys layout's fields in a tighter
    split (30 bits above the low word, not 31), so wherever flat fits,
    keys fits first: ``auto`` reaches mxu, keys and vmap on the grid and
    never flat, which only ``engine="flat"`` runs."""
    picks = {TB.pick_engine(*args) for P in PICK_P
             for args in _pick_grid(P)}
    assert picks == {"mxu", "keys", "vmap"}


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    """A host without the CUDA toolkit: the build raises, and nothing
    falls back to another engine (the port's rule: a device fault never
    passes as a verdict)."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("pair_sort")
    assert not (tmp_path / "_build").exists() or \
        not any((tmp_path / "_build").iterdir())
