#!/usr/bin/env python3
"""Request (g)'s ``check_batch`` on one CUDA card at several launch-slice
sizes, with the host's and the card's share of each run.

Run from the root of a checkout on a host with a card:

    python3 scripts/torch_batch_slices.py [--caps 0,512,1056,2112]
        [--reps 2]

``chip_smoke.py``'s request (g) (4096 histories of 2000 ops, its streams
built and cached first) goes through ``checker.batch.check_batch`` with
its launch slices capped at each size of ``--caps`` (0: one launch, as a
batch with cached streams runs), in turns, ``--reps`` times. It prints,
after the card's name and power limit, one JSON line per run: the wall;
the stream-kernel launches and their card time (CUDA events around each
``seg_search_stream`` call); and the host seconds in ``pack_groups``
(grouping and padding the slice's streams), ``upload`` (pinned copies
queued to the card), the launch calls, and ``stream_rows`` (waiting for
and gathering the results). The record goes to
``chiprun_out/batch_slices.json``. It imports nothing of JAX; without a
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", default="0,512,1056,2112",
                    help="slice sizes to time, comma-separated (0: one "
                         "launch)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_batch_slices: needs a CUDA card", file=sys.stderr)
        return 1

    import chip_smoke as CS
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.kernels import build
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import synth_columnar as SC

    print(CS._gpu_line())
    build.build_all()
    dev = torch.device("cuda", 0)
    print(f"one wave of the card: {SK.wave_streams(dev)} warp streams")
    cols = SC.register_batch_columns(11_000_000, CS.G_HISTORIES, CS.G_OPS,
                                     n_procs=5, values=5)
    batch = TB.pack_batch(SC.pack_register_columns(cols), cas_register(),
                          build_streams=False)
    del cols
    TB._stream_segments(batch)          # streams built and cached

    host = {}
    events = []

    def timed_host(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] = host.get(name, 0.0) + time.perf_counter() - t0
        return run

    def timed_launch(fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events.append((e0, e1))
            return out
        return run

    SK.pack_groups = timed_host("pack_groups", SK.pack_groups)
    SK.upload = timed_host("upload", SK.upload)
    SK.seg_search_stream = timed_host("launch", timed_launch(
        SK.seg_search_stream))
    SK.stream_rows = timed_host("stream_rows", SK.stream_rows)
    real_cap = TB._slice_cap
    caps = [int(c) for c in args.caps.split(",")]
    record = {"gpu": CS._gpu_line(), "wave": SK.wave_streams(dev),
              "runs": []}
    TB.check_batch(batch, F=128, device=dev)            # warm-up
    for rep in range(args.reps):
        for cap in (caps if rep % 2 == 0 else caps[::-1]):
            TB._slice_cap = (lambda d, c, n=cap: n or None)
            host.clear()
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _, _ = TB.check_batch(batch, F=128, device=dev)
            torch.cuda.synchronize()
            run = {"cap": cap, "wall_s": time.perf_counter() - t0,
                   "launches": len(events),
                   "card_ms": sum(a.elapsed_time(b) for a, b in events),
                   "host_s": dict(host), "valid": int((st == 0).sum())}
            record["runs"].append(run)
            print(json.dumps(run), flush=True)
    TB._slice_cap = real_cap
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "batch_slices.json"),
              "w") as fh:
        json.dump(record, fh, indent=1)
    return 0 if all(r["valid"] == CS.G_HISTORIES
                    for r in record["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
