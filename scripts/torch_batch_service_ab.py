#!/usr/bin/env python3
"""Request (g)'s batch and (sv1)'s service burst, timed in checkouts
side by side on one CUDA card.

Run from the root of a checkout on a host with a card:

    python3 scripts/torch_batch_service_ab.py --root ROOT [--root ROOT ...]

Each ``--root`` is a checkout of the port (this one is ``.``; unpack
another beside it with ``git archive <commit> | tar -x -C _archive/x``,
``_archive/`` being git-ignored). Each runs in its own process, in the
order given, so list them in turns (A B B A). After the card's name and
power limit it prints, per checkout, one JSON line:

- ``g``: ``chip_smoke.py``'s request (g) (4096 histories of 2000 ops)
  through ``check_batch``, first with its streams built in the call
  (``cold``), then twice from its cached streams: the wall, the
  stream-kernel launches and their card time (CUDA events around each
  ``seg_search_stream`` call), and the VALID count;
- ``sv1``: where the checkout has a service, ``chip_smoke.py``'s (sv1)
  burst (256 check requests from 64 connections) against that
  checkout's daemon: latency, stages, dispatches and what that
  checkout's ``_sv_burst`` reports besides.

The record goes to ``chiprun_out/batch_service_ab.json``. It imports
nothing of JAX; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as CS
from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.kernels import build
from comdb2_tpu_torch.models.model import cas_register
from comdb2_tpu_torch.ops import synth_columnar as SC

build.build_all()
dev = torch.device("cuda", 0)
out = {"root": sys.argv[1]}
real, calls = SK.seg_search_stream, []


def timed(*a, **kw):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    r = real(*a, **kw)
    e1.record()
    calls.append((e0, e1))
    return r


SK.seg_search_stream = timed
cols = SC.register_batch_columns(11_000_000, CS.G_HISTORIES, CS.G_OPS,
                                 n_procs=5, values=5)
batch = TB.pack_batch(SC.pack_register_columns(cols), cas_register(),
                      build_streams=False)
del cols
runs = []
for label in ("cold", "cached", "cached"):
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _, _ = TB.check_batch(batch, F=128, device=dev)
    torch.cuda.synchronize()
    runs.append({"run": label, "wall_s": time.perf_counter() - t0,
                 "launches": len(calls),
                 "card_ms": sum(a.elapsed_time(b) for a, b in calls),
                 "valid": int((st == 0).sum())})
SK.seg_search_stream = real
out["g"] = runs
del batch
if hasattr(CS, "_sv_burst"):
    hs, _ = CS._i_histories()
    want = TB.check_batch(TB.pack_batch(hs, cas_register()), F=1024,
                          device=dev)
    proc, ready = CS._start_daemon("--backend", "cuda", "--batch-cap",
                                   str(CS.SV_CAP))
    port = None if ready is None else ready["port"]
    rec = {}
    try:
        if port is None:
            raise SystemExit("the daemon did not start")
        CS._sv_burst(port, hs, want, rec)
    finally:
        CS._stop_daemon(proc, port)
    out["sv1"] = rec["sv1"]
print("AB " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout to time (repeat, in turns)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each checkout's process may take")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_batch_service_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as CS

    print(CS._gpu_line())
    record = {"gpu": CS._gpu_line(), "runs": []}
    rc = 0
    for root in args.root:
        try:
            p = subprocess.run([sys.executable, "-c", CHILD, root],
                               cwd=HERE, capture_output=True, text=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(f"{root}: timed out after {args.timeout:.0f} s")
            rc = 1
            continue
        lines = [ln[3:] for ln in p.stdout.splitlines()
                 if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            print(f"{root}: exit {p.returncode}\n{p.stderr[-3000:]}")
            rc = 1
            continue
        run = json.loads(lines[-1])
        record["runs"].append(run)
        print(json.dumps(run))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "batch_service_ab.json"),
              "w") as fh:
        json.dump(record, fh, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
