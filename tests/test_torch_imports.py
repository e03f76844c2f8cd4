"""Import guard of the PyTorch/CUDA port: ``comdb2_tpu_torch`` imports
neither ``jax`` nor anything of the JAX package ``comdb2_tpu``, and its
entry points never fall back to the CPU unasked."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import comdb2_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "comdb2_tpu_torch"


#: the shrink slice's subpackages and modules
SHRINK_SLICE = ("shrink", "shrink.core", "shrink.verdicts", "shrink.txn",
                "harness", "harness.store", "report", "report.svg",
                "report.linear_svg", "report.txn_svg", "report.shrink_svg")

#: the streaming slice's subpackage and modules
STREAM_SLICE = ("stream", "stream.engine", "stream.session",
                "stream.ingest", "stream.segment", "stream.checkpoint",
                "stream.wl", "stream.manager")


def _forbidden(name: str) -> bool:
    return (name in ("jax", "comdb2_tpu")
            or name.startswith(("jax.", "comdb2_tpu.")))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        comdb2_tpu_torch.__path__, "comdb2_tpu_torch."))


def test_package_has_the_slice_modules():
    mods = set(_all_modules())
    for m in ("ops.edn", "ops.history", "ops.packed", "ops.columnar",
              "ops.synth", "ops.synth_columnar", "models.memo",
              "obs.trace", "checker.linear_host", "checker.linear_torch",
              "checker.seg_kernel", "checker.counterexample",
              "checker.linear", "checker.mxu", "checker.batch",
              "checker.pair_sort", "kernels.build", "convert",
              "filetest", "utils.intervals", "checker.checkers",
              "checker.independent", "checker.workloads", "checker.wgl",
              "checker.wl.bank", "checker.wl.sets", "checker.wl.dirty",
              "checker.wl.batch", "checker.wl.synth", "txn.edges",
              "txn.scc", "txn.closure_torch", "txn.counterexample",
              "txn.check", "txn.adapters", "checker.brute",
              "ops.native_loader") + SHRINK_SLICE + STREAM_SLICE:
        assert f"comdb2_tpu_torch.{m}" in mods, m
    for src in ("seg_search.cu", "pair_sort.cu"):
        assert (PKG / "kernels" / src).exists(), src


def test_import_pulls_in_no_jax_in_a_fresh_interpreter():
    code = (
        "import importlib, pkgutil, sys\n"
        "import comdb2_tpu_torch\n"
        "for m in pkgutil.walk_packages(comdb2_tpu_torch.__path__,\n"
        "                               'comdb2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'comdb2_tpu')\n"
        "             or n.startswith(('jax.', 'comdb2_tpu.')))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('comdb2_tpu_torch')]))\n"
        "print(bad)\n"
        "print(sorted(n[len('comdb2_tpu_torch.'):] for n in sys.modules\n"
        "             if n.startswith(('comdb2_tpu_torch.shrink',\n"
        "                              'comdb2_tpu_torch.harness',\n"
        "                              'comdb2_tpu_torch.report'))))\n"
        "print(sorted(n[len('comdb2_tpu_torch.'):] for n in sys.modules\n"
        "             if n.startswith('comdb2_tpu_torch.stream')))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_loaded, bad, slice_mods, stream_mods = r.stdout.strip().splitlines()
    assert int(n_loaded) >= 20
    assert bad == "[]"
    assert sorted(SHRINK_SLICE) == eval(slice_mods)
    assert sorted(STREAM_SLICE) == eval(stream_mods)


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    scanned = {str(p.relative_to(PKG).with_suffix("")).replace("/", ".")
               .replace(".__init__", "") for p in PKG.rglob("*.py")}
    assert set(SHRINK_SLICE) <= scanned
    assert set(STREAM_SLICE) <= scanned
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [(path.name, n) for n in names if _forbidden(n)]
    assert found == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)]


def test_analysis_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import op as O

    h = [O.invoke(0, "write", 1), O.ok(0, "write", 1)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis(cas_register(), h)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis(cas_register(), h, device="cuda")
    assert analysis(cas_register(), h, device="cpu").valid is True


def test_filetest_without_device_raises_when_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from comdb2_tpu_torch import filetest

    p = tmp_path / "h.edn"
    p.write_text("{:type :invoke, :f :write, :value 1, :process 0}\n"
                 "{:type :ok, :f :write, :value 1, :process 0}\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        filetest.main([str(p)])
    assert filetest.main([str(p), "--device", "cpu"]) == 0


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (or on a host without
    CUDA) the script exits non-zero and prints no result line."""
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("engine", ["check_device", "check_device_batch",
                                    "check_device_seg_batch",
                                    "check_device_flat"])
def test_new_engines_without_device_raise_when_cuda_is_absent(engine):
    """The engines run on ``cuda`` unless asked for the CPU: given host
    arrays and no device on a host without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    import numpy as np

    from comdb2_tpu_torch.checker import linear_torch as LT

    succ = np.zeros((2, 2), np.int32)
    one = np.zeros((1, 1), np.int32)
    args = {"check_device": (succ, one[0], one[0], one[0]),
            "check_device_batch": (succ, one, one, one),
            "check_device_seg_batch": (succ, one[None], one[None], one,
                                       one),
            "check_device_flat": (succ, one[None], one[None], one,
                                  one[0])}[engine]
    kw = dict(F=8, P=2)
    if engine == "check_device_flat":
        kw.update(B=1, n_states=2, n_transitions=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(LT, engine)(*args, **kw)
