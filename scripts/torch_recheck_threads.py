"""Time a chaos register test's plain re-check at several torch thread
counts, alone and beside processes that spin.

Runs ``workloads.comdb2.register_tester`` over ``MemDB(chaos_unknown=0.01,
chaos_fail=0.05, seed=2026)`` for 10 s at ``device="cpu"`` (the test of
``chip_smoke.py``'s (x2)) until its lone key's answer needs the seg2
ladder's 8192 rung, then checks that one history again with the
tester's checkers at ``device="cpu"`` at each ``--threads`` count, once
for each ``--burners`` count of spinning processes beside it. Prints one
JSON line per check; touches no card.

    python3 scripts/torch_recheck_threads.py --threads 1 2 4 8 --burners 0
    python3 scripts/torch_recheck_threads.py --threads 1 2 4 --burners 8
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from comdb2_tpu_torch.harness import core  # noqa: E402
from comdb2_tpu_torch.models.model import cas_register  # noqa: E402
from comdb2_tpu_torch.workloads import comdb2 as W  # noqa: E402
from comdb2_tpu_torch.workloads.sqlish import MemDB  # noqa: E402

CHAOS = {"chaos_unknown": 0.01, "chaos_fail": 0.05, "seed": 2026}


class _NoCheck:
    def check(self, test, model, history, opts=None):
        return {"valid?": True}


def _recheck(history, root):
    """The tester's checkers at device="cpu" on ``history``: (seconds,
    the lone key's engine and frontier capacity)."""
    t0 = time.perf_counter()
    res = W.register_tester(device="cpu")["checker"].check(
        {"name": "recheck", "dir": tempfile.mkdtemp(dir=root)},
        cas_register(), history)
    (r,) = res["linearizable"]["results"].values()
    return time.perf_counter() - t0, r.get("engine"), \
        r.get("frontier_capacity")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--burners", type=int, nargs="+", default=[0])
    ap.add_argument("--tries", type=int, default=8,
                    help="test runs to find a history at the 8192 rung")
    a = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        for _ in range(a.tries):
            random.seed(20)
            t = W.register_tester(connect=MemDB(**CHAOS).connect,
                                  time_limit=10.0, device="cpu")
            t.update({"nodes": [], "store-root": root,
                      "checker": _NoCheck()})
            h = core.run(t)["history"]
            torch.set_num_threads(4)
            if _recheck(h, root)[2] == 8192:
                break
        else:
            print("no history reached the 8192 rung", file=sys.stderr)
            return 1
        infos = sum(op.type == "info" for op in h)
        for burners in a.burners:
            procs = [subprocess.Popen([sys.executable, "-c",
                                       "while True: pass"])
                     for _ in range(burners)]
            try:
                for n in a.threads:
                    torch.set_num_threads(n)
                    s, engine, cap = _recheck(h, root)
                    print(json.dumps({
                        "cores": os.cpu_count(), "burners": burners,
                        "threads": n, "seconds": round(s, 2),
                        "engine": engine, "capacity": cap,
                        "events": len(h), "info": infos}), flush=True)
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
