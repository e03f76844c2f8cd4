"""Run a control in the program's place over a cell's inputs, and judge
its answers as a run judges the program's.

    python3 perfbench/control.py --workload <cell> --control <name> \
        --calls <n> --seeds <s> [<s> ...]

For each seed: the cell's pool from that seed, the answers of ``n``
calls as the window would make them (call ``j`` on input ``j mod
pool``), each from the control (:mod:`perfbench.reference.control`), and
the numbers that decide ``correct``, sampled as an untraced run samples.
One JSON line per seed. The program is not loaded: a control is the
plain reference with a guarantee broken. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

from perfbench.lib import cells, harness  # noqa: E402
from perfbench.reference import control  # noqa: E402


def control_run(cell, seed: int, n_calls: int, name: str) -> dict:
    caller = cell.caller().Caller(cell, seed, "cpu")
    caller.make_pool()
    answer = control.CONTROLS[name]
    got: dict = {}                      # a unit's answer, made once
    calls = []
    for j in range(n_calls):
        c = harness.Call(j, 0.0, 0.0, caller.ops(j))
        for u in caller.units(j):
            if u not in got:
                got[u] = answer(caller.history(u))
            c.answers[u] = got[u]
        calls.append(c)
    checks, _ = harness.check_answers(caller, calls, seed, full=False)
    return {"seed": seed, "control": name, "calls": n_calls,
            "correct": all(harness.holds(c) for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=sorted(control.CONTROLS),
                    required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    cell = cells.load(ROOT, a.workload)
    for seed in a.seeds:
        t = time.monotonic()
        r = control_run(cell, seed, a.calls, a.control)
        r["seconds"] = time.monotonic() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
