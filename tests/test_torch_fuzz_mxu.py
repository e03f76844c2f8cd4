"""The port's MXU-engine fuzz (``scripts/torch_fuzz_mxu.py``) on CPU
tensors, against the JAX package's engines on the same packed inputs.

Seeds: register 3000, 3001 and 3004 (the first INVALID one), waves
4000 and 4001 at P = 16 and 24 (one valid, one violation each) — the
JAX package's ``scripts/fuzz_mxu.py`` families, whose histories each
package builds from the same seed. Every case's verdict, fail segment
and VALID count from the port's ``seg`` and ``mxu`` engines equal the
JAX package's ``linear_jax.check_device_seg`` at the same F and bucket,
exactly, and on the register seeds (F = 128) its ``mxu.check_device_mxu``
too. The JAX package's MXU engine at F = 1024 takes 18 s for one P = 16
wave on this CPU and minutes at P = 24, so the wave cases are held to
its seg engine, which its own fuzz holds its MXU engine to.
"""
from __future__ import annotations

import importlib.util
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = {"register": [3000, 3001, 3004], "waves-p16": [4000, 4001],
         "waves-p24": [4000, 4001]}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fuzz():
    return _load("torch_fuzz_mxu", os.path.join("scripts",
                                                "torch_fuzz_mxu.py"))


@pytest.fixture(scope="module")
def artifact(fuzz):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fuzz.run(0, "cpu", seeds=SEEDS)
    finally:
        torch.set_num_threads(n)


def _jax_case(family, seed):
    """The JAX package's fuzz construction of one seed: ``(packed,
    segs, P, F)`` through its own generators, packer and segmenter."""
    from comdb2_tpu.checker import linear_jax as LJ
    from comdb2_tpu.models.memo import memo as make_memo
    from comdb2_tpu.models.model import cas_register
    from comdb2_tpu.ops import synth_columnar as SC
    from comdb2_tpu.ops.packed import pack_history
    from comdb2_tpu.ops.synth import mutate, register_history

    rng = random.Random(seed)
    if family == "register":
        h = register_history(rng, n_procs=rng.randint(2, 5),
                             n_events=rng.randint(10, 60), values=3,
                             p_info=0.05)
        if rng.random() < 0.5:
            h = mutate(rng, h)
        packed = pack_history(h)
        segs = LJ.make_segments(packed, s_pad=64, k_pad=8)
        segs, p_eff = LJ.remap_slots(segs)
        P, F = max(p_eff, 1), 128
    else:
        P = int(family.rsplit("p", 1)[1])
        n_free = rng.randint(2, 6)
        n_chain = P - n_free
        n_waves = rng.randint(1, 3)
        violation = rng.random() < 0.5
        cols = SC.wide_register_batch_columns(
            seed, 1, n_waves, n_chain, n_free, values=max(16, n_chain + 2),
            violation=violation)
        packed = SC.pack_register_columns(cols)[0]
        segs = LJ.make_segments(packed, s_pad=128, k_pad=32)
        segs, p_eff = LJ.remap_slots(segs)
        P, F = p_eff, 1024
    mm = make_memo(cas_register(), packed)
    return mm, segs, P, F


def test_the_fuzz_passes_on_cpu_with_both_verdict_classes(artifact):
    assert artifact["verdict"] == "PASS" and artifact["device"] == "cpu"
    fams = artifact["families"]
    for fam in SEEDS:
        assert fams[fam]["ok"] and fams[fam]["inv"], fams
        assert fams[fam]["seeds"] == len(SEEDS[fam])
    assert fams["register"]["kernel-crosschecked"] == 3
    assert "unk" not in fams["waves-p16"] and "unk" not in fams["waves-p24"]
    assert len(artifact["cases"]) == 7


def test_every_case_equals_the_jax_package(fuzz, artifact):
    """Verdict and fail segment always, the count on VALID, of the port's
    seg and MXU engines against the JAX package's on its own packing of
    the same seed; the segments, P and table equal too."""
    from comdb2_tpu.checker import linear_jax as LJ
    from comdb2_tpu.checker import mxu as JMXU

    for case in artifact["cases"]:
        fam, seed = case["family"], case["seed"]
        mm, segs, P, F = _jax_case(fam, seed)
        assert (P, F) == (case["P"], case["F"]), case
        got = (fuzz.register_case(seed) if fam == "register"
               else fuzz.wave_case(P, seed))
        t_segs = got[2]
        for field in ("inv_proc", "inv_tr", "ok_proc", "depth",
                      "seg_index"):
            np.testing.assert_array_equal(np.asarray(getattr(segs, field)),
                                          np.asarray(getattr(t_segs,
                                                             field)))
        np.testing.assert_array_equal(mm.succ, got[1].succ)
        succ = LJ.pad_succ(mm.succ, *fuzz.BUCKET)
        sizes = dict(n_states=fuzz.BUCKET[0],
                     n_transitions=fuzz.BUCKET[1])
        args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
        want = {"seg": tuple(int(x) for x in LJ.check_device_seg(
            *args, F=F, P=P, **sizes))}
        if fam == "register" and JMXU.fits(fuzz.BUCKET[0],
                                           fuzz.BUCKET[1], P):
            want["mxu"] = tuple(int(x) for x in JMXU.check_device_mxu(
                *args, F=F, P=P, **sizes))
        for t_eng in ("seg", "mxu"):
            t_st, t_fa, t_n = case["verdicts"][t_eng]
            for eng, (st, fa, n) in want.items():
                assert t_st == st, (fam, seed, t_eng, eng, case, want)
                if st == 0:
                    assert t_n == n, (fam, seed, t_eng, eng, case, want)
                else:
                    assert t_fa == fa, (fam, seed, t_eng, eng, case, want)


def test_a_floor_missed_raises(fuzz):
    """Two valid register seeds alone miss the both-classes floor."""
    with pytest.raises(AssertionError):
        fuzz.run(0, "cpu", seeds={"register": [3000, 3001],
                                  "waves-p16": [], "waves-p24": []})


def test_cuda_without_a_card_raises_before_any_work():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "torch_fuzz_mxu.py"), "2"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "register" not in r.stdout
