"""The benchmark's own tests, apart from the repository's suite: they
import nothing of JAX. Run them from the repository's root:

    python -m pytest perfbench/tests -q              # CPU; card tests skip
    python -m pytest perfbench/tests -q -m cuda      # on a card host
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")


@pytest.fixture()
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: sizes at which the program's plain kernel versions check a cell's
#: inputs in seconds on the CPU
SMALL = {"ctest-register-5t": ({"n_events": 2000},
                               {"invalid_share": 0.5}),
         "comdb2-register-tester": ({"n_events": 240},
                                    {"invalid_share": 0.5})}


@pytest.fixture()
def small_root(tmp_path):
    """A checkout's root holding ``BENCHMARK.json`` and a copy of
    ``perfbench/``, its configurations cut to :data:`SMALL` and every
    traffic mix's pool to 4, so that a cell's first calls meet an
    INVALID and a VALID input."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (history, top) in SMALL.items():
        p = tmp_path / "perfbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["history"] = {**c["history"], **history}
        c.update(top)
        p.write_text(json.dumps(c))
    for p in (tmp_path / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["pool"] = 4
        p.write_text(json.dumps(t))
    return str(tmp_path)
