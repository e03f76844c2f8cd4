"""Nothing a run loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
plain reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "comdb2_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.lib import cells, harness
for cell in ("ctest5p.single", "register10p.indep"):
    r = harness.run_cell(cells.load({small!r}, cell), 5, 1.0, {trace},
                         device="cpu")
    assert r["correct"], r
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax(small_root):
    for trace in (False, True):
        mods = _modules(RUN.format(root=ROOT, small=small_root,
                                   trace=trace))
        assert "comdb2_tpu_torch" in mods and "torch" in mods
        assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        f"import json, sys; sys.path.insert(0, {ROOT!r})\n"
        "import perfbench.reference.linear, perfbench.reference.control\n"
        "import perfbench.gen.pool, perfbench.lib.roofline\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (FORBIDDEN | {"comdb2_tpu_torch", "torch", "numpy"})


def test_without_a_card_a_run_prints_nothing_and_fails(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this host has a card")
    for root in (ROOT, str(tmp_path)):
        if root != ROOT:
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
            shutil.copytree(os.path.join(ROOT, "perfbench"),
                            os.path.join(root, "perfbench"),
                            ignore=shutil.ignore_patterns("__pycache__"))
        r = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "ctest5p.single", "--seed", str(2**31 + 1), "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=root)
        assert r.returncode != 0 and r.stdout == ""
