"""CLI: ``python -m comdb2_tpu_torch.analysis [paths...]``.

With no paths: the full repo-wide run over the port (lint over
``comdb2_tpu_torch/`` and the port's files in ``scripts/`` and
``tests/``; the production Hopper budgets and the constant mirror; the
bucket closure; the kernel-surface prover; lifecycle; dataflow; the
stale-suppression audit). With explicit paths: the file-level passes
only — the mode the seeded violation fixtures
(``tests/fixtures/analysis_torch/``) use. ``--changed [REF]`` checks
only the files that differ from a git ref (default HEAD) plus untracked
files.

``--card`` adds the card halves after the static passes: the budget
read back from the built kernels at every production tier
(:func:`.kernel_budget.check_built`) and the mixed workload under the
launch guard (:func:`.compile_surface.mixed_workload`). Without
``--card`` the CLI never touches a device; with it, a host without a
card, without ``nvcc`` or with a library that fails to build fails the
run.

Exits non-zero when any finding survives suppression — including when
``--json`` writes the findings artifact. Each finding prints as
``rule-id path:line message``; per-pass wall times go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from . import (Finding, changed_files, run_paths_staged,
               run_repo_staged)


def _card_stages() -> list:
    """The card halves as timed stages (each raises without a card)."""
    import time

    from . import compile_surface, kernel_budget

    out = []
    t0 = time.monotonic()
    findings, report = kernel_budget.check_built()
    out.append(("kernel-budget[card]", findings,
                time.monotonic() - t0))
    print("card budget: " + json.dumps(
        {k: v for k, v in report.items() if k != "kernels"}),
        file=sys.stderr)
    t0 = time.monotonic()
    res = compile_surface.mixed_workload("cuda")
    out.append(("compile-surface[card]", [], time.monotonic() - t0))
    print(f"card mixed workload: {len(res['variants'])} variants "
          f"inside the inventory; unbucketed control caught",
          file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m comdb2_tpu_torch.analysis",
        description="repo-wide static invariant checker of the port")
    p.add_argument("paths", nargs="*",
                   help="explicit files to check (default: the port)")
    p.add_argument("--changed", nargs="?", const="HEAD",
                   default=None, metavar="REF",
                   help="check only the port's .py files changed vs REF "
                        "(git diff + untracked; default HEAD)")
    p.add_argument("--no-trace", action="store_true",
                   help="skip the compile-surface witness table")
    p.add_argument("--budget-table", metavar="PATH",
                   help="write the checked Hopper budget table artifact "
                        "(markdown) and continue")
    p.add_argument("--programs", metavar="PATH",
                   help="write the kernel-surface inventory artifact "
                        "(docs/programs_torch.md) and continue")
    p.add_argument("--json", metavar="PATH", dest="json_out",
                   help="also write findings as JSON (does not change "
                        "the exit code)")
    p.add_argument("--card", action="store_true",
                   help="also run the card halves: the budget read back "
                        "from the built kernels and the mixed workload "
                        "under the launch guard (needs a CUDA card)")
    args = p.parse_args(argv)

    if args.budget_table:
        from . import kernel_budget

        with open(args.budget_table, "w") as fh:
            fh.write(kernel_budget.budget_table())
        print(f"budget table written: {args.budget_table}")

    if args.programs:
        from . import compile_surface

        with open(args.programs, "w") as fh:
            fh.write(compile_surface.render_programs())
        print(f"program inventory written: {args.programs}")

    if args.changed is not None and args.paths:
        p.error("--changed and explicit paths are mutually exclusive")
    if args.json_out:
        import os
        if any(os.path.realpath(args.json_out) == os.path.realpath(pp)
               for pp in args.paths):
            p.error("--json PATH is the findings artifact to WRITE — "
                    "it matches one of the files under check")
    if args.changed is not None:
        try:
            paths = changed_files(args.changed)
        except RuntimeError as exc:
            print(f"--changed: {exc}", file=sys.stderr)
            return 2
        if not paths and not args.card:
            if args.json_out:
                with open(args.json_out, "w") as fh:
                    json.dump([], fh)
            print(f"OK: 0 findings (no files changed vs "
                  f"{args.changed})")
            return 0
        print(f"--changed {args.changed}: {len(paths)} file(s)",
              file=sys.stderr)
        stages = run_paths_staged(paths)
    elif args.paths:
        stages = run_paths_staged(args.paths)
    else:
        stages = run_repo_staged(trace=not args.no_trace)
    if args.card:
        stages += _card_stages()

    findings: List[Finding] = [f for _, fs, _ in stages for f in fs]
    for f in findings:
        print(f.format())
    for name, fs, secs in stages:
        print(f"pass {name}: {len(fs)} finding(s) in {secs:.2f}s",
              file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump([f.__dict__ for f in findings], fh, indent=1)
    if findings:
        print(f"FAIL: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("OK: 0 findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
