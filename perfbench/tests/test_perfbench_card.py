"""Each cell for a few seconds on the card, untraced and traced, through
``perfbench/run.py`` as the benchmark's check runs it. Skips on a host
without a card; on a card host:

    python -m pytest perfbench/tests -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["ctest5p.single", "register10p.indep"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda, cell, trace):
    with open(f"{ROOT}/BENCHMARK.json") as fh:
        bench = json.load(fh)
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 4242 + trace), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    want = {m["name"] for m in bench["per_layer" if trace else
                                     "end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    if trace:
        dev = out["device"]
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert dev["trace_device_ops"] > 0
        assert dev["trace_calls"] <= out["attempted"]
