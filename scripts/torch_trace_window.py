"""One window of a benchmark cell with the program's spans on, and what
the result line does not hold: the spans that the trace buffer dropped,
how much of each check span its stage spans cover, the window's rate
under tracing, and the collector's pauses and the rate in each half of
the window.

    python3 scripts/torch_trace_window.py --workload ctest5p.single \\
        --seed 2147483711 --seconds 51
    python3 scripts/torch_trace_window.py ... --spans-only

Run from the repository's root. The default is the benchmark's traced
run (``perfbench/run.py --trace 1``: spans, CUDA events, the profiler).
``--spans-only`` runs the untraced window with only the program's spans
(and the collector's) on, so that its ``check_ops_per_s`` beside an
untraced run on the same seed is the spans' own cost. It exits 2 when
it caught no window's spans, or (traced) no window, so that its
``dropped_spans`` is always a reading. Prints one JSON line and writes
it to
``chiprun_out/trace_window/<workload>.<seed>.<seconds>[.spans].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a check span -> the name prefixes of the stage spans that should
#: cover it; ``linear.decode`` only where it decoded an INVALID verdict
#: (it holds a ``linear.decode.ops`` span)
STAGES = {"linear.pack": ("ops.pack", "memo.build", "gc."),
          "linear.segments": ("segments.make", "segments.remap", "gc."),
          "linear.decode": ("counterexample.", "segments.",
                            "linear.decode.ops", "gc.")}


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def stage_coverage(spans) -> dict:
    """``{check span: share of its seconds that its stage spans cover}``
    over ``spans`` (``obs.trace.Span`` objects), with the seconds and
    the number of check spans measured, and each stage's seconds inside
    them."""
    spans = sorted((s for s in spans if s.t1 is not None),
                   key=lambda s: s.t0)
    out = {}
    for parent, prefixes in STAGES.items():
        held = covered = 0.0
        n = 0
        by_stage: dict = {}
        for p in (s for s in spans if s.name == parent):
            if parent == "linear.decode" and not any(
                    s.name == "linear.decode.ops" for s in spans
                    if p.t0 <= s.t0 and s.t1 <= p.t1):
                continue
            inside = [(s.name, max(s.t0, p.t0), min(s.t1, p.t1))
                      for s in spans
                      if s is not p and s.t0 < p.t1 and s.t1 > p.t0
                      and s.name.startswith(prefixes)]
            held += p.t1 - p.t0
            covered += _union((a, b) for _, a, b in inside)
            n += 1
            for name, a, b in inside:
                by_stage[name] = by_stage.get(name, 0.0) + b - a
        out[parent] = {"share": covered / held if held else None,
                       "seconds": held, "spans": n, "stages": by_stage}
    return out


def collections_by_parent(spans) -> dict:
    """``{span a collection paused: [full ones, their seconds, young
    ones, their seconds]}``."""
    out: dict = {}
    for s in spans:
        if s.name.startswith("gc."):
            row = out.setdefault(s.parent.name if s.parent else "-",
                                 [0, 0.0, 0, 0.0])
            i = 0 if s.name == "gc.full" else 2
            row[i] += 1
            row[i + 1] += s.t1 - s.t0
    return out


def halves(ctx, spans) -> list:
    """The window's first and second half: the rate of the calls that
    started in it, and the collector's pauses in it."""
    mid = (ctx.w0 + ctx.w1) / 2
    out = []
    for a, b in ((ctx.w0, mid), (mid, ctx.w1)):
        calls = [c for c in ctx.calls if a <= c.t0 < b and c.error is None]
        took = sum(c.t1 - c.t0 for c in calls)
        gc_spans = [s for s in spans if s.name.startswith("gc.")
                    and a <= s.t0 < b]
        out.append({
            "calls": len(calls),
            "ops_per_s": sum(c.ops for c in calls) / took if took else None,
            "gc_s": sum(s.t1 - s.t0 for s in gc_spans),
            "gc_full": sum(1 for s in gc_spans if s.name == "gc.full"),
            "gc_full_s": sum(s.t1 - s.t0 for s in gc_spans
                             if s.name == "gc.full")})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_trace_window.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from comdb2_tpu_torch.obs import trace as obs
    from perfbench.lib import cells, harness

    cell = cells.load(ROOT, args.workload)
    # the window's spans and drop count, read as the harness clears them
    kept = {"spans": [], "dropped": 0}
    real_clear = obs.clear

    def clear():
        if obs.spans():
            kept["spans"], kept["dropped"] = obs.spans(), obs.dropped_spans()
        real_clear()

    seen = {}
    real_breakdown = harness.breakdown

    def breakdown(ctx, *a, **kw):
        seen["ctx"] = ctx
        return real_breakdown(ctx, *a, **kw)

    obs.clear, harness.breakdown = clear, breakdown
    try:
        if args.spans_only:
            obs.enable()
            try:
                r = harness.run_cell(cell, args.seed, args.seconds, False,
                                     device="cuda")
            finally:
                obs.disable()
            kept["spans"], kept["dropped"] = obs.spans(), obs.dropped_spans()
            real_clear()
        else:
            r = harness.run_cell(cell, args.seed, args.seconds, True,
                                 device="cuda")
    finally:
        obs.clear, harness.breakdown = real_clear, real_breakdown
    ctx = seen.get("ctx")
    if not kept["spans"] or (ctx is None and not args.spans_only):
        print("caught no window's spans: the harness no longer clears "
              "them through obs.clear, or reads them another way",
              file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "spans_only": args.spans_only,
           "correct": r["correct"], "device": r["device"],
           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "dropped_spans": kept["dropped"], "spans": len(kept["spans"])}
    if ctx is not None:
        window = [s for s in kept["spans"]
                  if s.t1 is not None and ctx.w0 <= s.t0 and s.t1 <= ctx.w1]
        out["traced_check_ops_per_s"] = ctx.kops * 1e3 / ctx.window_s
        out["stage_coverage"] = stage_coverage(window)
        out["halves"] = halves(ctx, window)
        out["collections_by_parent"] = collections_by_parent(window)
        out["breakdown"] = r.get("breakdown")
    path = os.path.join(
        ROOT, "chiprun_out", "trace_window",
        f"{args.workload}.{args.seed}.{args.seconds:g}"
        f"{'.spans' if args.spans_only else ''}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0 if r["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
