"""Data-driven: a cell, a configuration, a traffic mix and a per-layer
metric added only as files and entries are found by name and run."""

import json
import os

from perfbench.lib import cells, harness


def test_a_cell_added_as_files_is_found_and_run(small_root):
    root = small_root
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "ctest-register-5t.json")) as fh:
        c = json.load(fh)
    c["name"] = "ctest-register-3t"
    c["history"].update(n_procs=3, n_events=1000)
    c["invalid_share"] = 0.5
    with open(os.path.join(pb, "configs", "ctest-register-3t.json"),
              "w") as fh:
        json.dump(c, fh)
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as fh:
        json.dump({"kind": "analysis", "pool": 4, "reference_sample": 4},
                  fh)
    with open(os.path.join(pb, "metrics", "calls_in_window.py"),
              "w") as fh:
        fh.write("def read(ctx):\n    return len(ctx.calls)\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "ctest-register-3t", "source": "x",
                             "file": "perfbench/configs/"
                                     "ctest-register-3t.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ctest3p.tiny",
                               "config": "ctest-register-3t",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "checker entry",
                               "moves": "check_ops_per_s",
                               "workloads": ["ctest3p.tiny"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)

    cell = cells.load(root, "ctest3p.tiny")
    assert cell.config["history"]["n_procs"] == 3
    assert cell.traffic["pool"] == 4
    assert "calls_in_window" in [m["name"] for m in cell.per_layer]
    assert "calls_in_window" not in [
        m["name"] for m in cells.load(root, "ctest5p.single").per_layer]
    r = harness.run_cell(cell, 2**31 + 99, 1.0, True, device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls_in_window"]["value"] == r["attempted"] >= 2
    r = harness.run_cell(cell, 2**31 + 99, 1.0, False, device="cpu")
    assert set(r["metrics"]) == {"check_ops_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
