"""The port's segment-search fuzz (``scripts/torch_fuzz_seg.py``) on
CPU tensors, where the kernel's wrapper runs its plain version: two
seeds per family, every stage, and the same families and histories as
the JAX package's ``scripts/fuzz_pallas_seg.py``."""
from __future__ import annotations

import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fuzz():
    return _load("torch_fuzz_seg", os.path.join("scripts",
                                                "torch_fuzz_seg.py"))


@pytest.fixture(scope="module")
def ref_cases():
    ref = _load("fuzz_pallas_seg", os.path.join("scripts",
                                                "fuzz_pallas_seg.py"))
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return ref._cross_model_cases()
    finally:
        os.chdir(cwd)


def _fields(h):
    return [(o.process, o.type, o.f, o.value) for o in h]


def test_families_are_the_reference_scripts(fuzz, ref_cases):
    assert [n for n, _ in fuzz.families()] == [n for n, _ in ref_cases]


@pytest.mark.parametrize("seed", [500, 501])
def test_families_generate_the_reference_histories(fuzz, ref_cases,
                                                   seed):
    for (name, case), (_, ref_case) in zip(fuzz.families(), ref_cases):
        model, h = case(random.Random(seed))
        ref_model, ref_h = ref_case(random.Random(seed))
        assert type(model).__name__ == type(ref_model).__name__, name
        assert _fields(h) == _fields(ref_h), name


def test_fuzz_two_seeds_per_family_on_cpu(fuzz):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        art = fuzz.run(2, "cpu")
    finally:
        torch.set_num_threads(n)
    assert art["verdict"] == "PASS" and art["device"] == "cpu"
    assert set(art["families"]) == {"register", "mutex",
                                    "unordered-queue", "multi-register"}
    assert art["total_cross_checked"] == 8
    assert art["renamed_slots_cross_checked"] == 8


def test_cli_writes_the_artifact(tmp_path):
    out = tmp_path / "fuzz.json"
    r = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_fuzz_seg.py"),
         "4", "--device", "cpu", "--out", str(out)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    art = json.loads(out.read_text())
    assert art["seeds_per_family"] == 4
    assert art["stream_histories_cross_checked"] >= 1


def test_cuda_default_raises_without_a_card(fuzz):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuzz.run(1)
