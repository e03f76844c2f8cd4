#!/usr/bin/env python3
"""Kill-cluster diff-oracle runner over the port — the reference's
``killcluster/killclustertest.sh`` as a CLI over
:mod:`comdb2_tpu_torch.harness.killcluster` (the counterpart of the JAX
package's ``scripts/killclustertest.py``, with the same options and
output).

Runs the scripted deterministic transaction against the in-memory SUT
(or any backend via the --chaos knobs), optionally disrupting
mid-flight, and diffs the transcript against the generated oracle.
Prints one JSON line; exit 0 iff the transcript matches exactly, 1 on a
diff, 2 when the run ended unknown. Host code only: no device.

Usage: python3 scripts/torch_killclustertest.py [-n ROWS]
           [--chaos-fail P] [--chaos-unknown P] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from comdb2_tpu_torch.harness import killcluster          # noqa: E402
from comdb2_tpu_torch.workloads.sqlish import MemDB       # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-n", "--rows", type=int, default=2_000_000,
                   help="oracle transaction size (reference: 2M rows)")
    p.add_argument("--chaos-fail", type=float, default=0.0)
    p.add_argument("--chaos-unknown", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    db = MemDB(chaos_fail=args.chaos_fail,
               chaos_unknown=args.chaos_unknown, seed=args.seed)
    r = killcluster.run(
        {}, lambda: killcluster.scripted_workload(db.connect(),
                                                  args.rows),
        killcluster.oracle(args.rows))
    out = {"valid?": r["valid?"], "lines": r["lines"],
           "expected-lines": r["expected-lines"]}
    if r["diff"]:
        out["first-diff"] = r["diff"][0]
    if "error" in r:
        out["error"] = r["error"]
    print(json.dumps(out))
    if r["valid?"] is True:
        return 0
    return 2 if r["valid?"] == "unknown" else 1


if __name__ == "__main__":
    sys.exit(main())
