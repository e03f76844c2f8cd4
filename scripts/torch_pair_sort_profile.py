#!/usr/bin/env python3
"""Times of the port's pair-sort kernel (``comdb2_tpu_torch/kernels/
pair_sort.cu``) on one CUDA card, beside ``torch.sort`` on the int64 key.

Run from the root of a checkout on a host with a card:

    python3 scripts/torch_pair_sort_profile.py [--reps 50] [--stamps]
        [--h-wall ROOT ...]

On rows shaped like the keys engine's blocks in ``chip_smoke.py``'s
request (h) — (8, 131072): 73,728 keys with few distinct ``hi`` words
and a tail of the block's sentinel — and on (256, 4096) and (8, 4096),
it prints after the card's name and power limit:

- the registers and spills per thread of each kernel (read from the
  loaded library), its tile T and its dynamic shared memory per CTA;
- that the kernel is bit-equal to the plain version on those rows and on
  all-equal and reversed rows;
- CUDA-event times with the card queued ahead of the host
  (``utils.queued_ms``), taken in turns: the kernel, ``torch.sort``,
  ``torch.sort``, the kernel;
- the time of each launch of one sort: the block sort, then each merge
  pass;
- with ``--stamps``, one sort at (8, 131072) through a ``-DPS_PROFILE``
  build, whose CTAs stamp the ``%globaltimer`` at the end of each phase:
  per launch, when its CTAs enter and finish, and each phase's median and
  largest time in a CTA;
- with ``--h-wall ROOT``, the wall time of request (h)'s ``check_batch``
  run by the checkout at ROOT (its own kernels, its own process), so that
  a parent commit unpacked beside this one can be timed in turns with it.

The record goes to ``chiprun_out/pair_sort_profile.json``. It imports
nothing of JAX and falls back to nothing: without a card, or if a build
fails or disagrees, it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SHAPES = ((8, 131072), (256, 4096), (8, 4096))

# request (h) of the checkout named in argv[1]: its kernels built, its
# batch packed, then check_batch at F = 8192 three times (host clock
# around each, ending in a synchronise)
H_WALL = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as CS
from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.checker import pair_sort as PSORT
from comdb2_tpu_torch.kernels import build
from comdb2_tpu_torch.models.model import cas_register
build.build_all()
batch = TB.pack_batch(CS._h_histories(), cas_register())
real_sort, calls = PSORT.pair_sort, [0]


def counted_sort(*a, **kw):
    calls[0] += 1
    return real_sort(*a, **kw)


PSORT.pair_sort = counted_sort
walls = []
for _ in range(3):
    calls[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TB.check_batch(batch, F=8192)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
print(json.dumps({"walls": walls, "pair_sort_calls": calls[0]}))
"""


def _rows(B, N, kind, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    real = N * 9 // 16                  # 73,728 of 131,072
    hi = torch.randint(-8, 8, (B, N), generator=g, dtype=torch.int32)
    lo = torch.randint(-2**31, 2**31 - 1, (B, N), generator=g,
                       dtype=torch.int32)
    hi[:, real:] = 1 << 30
    lo[:, real:] = torch.arange(B, dtype=torch.int32)[:, None]
    if kind == "equal":
        hi.fill_(7)
        lo.fill_(-1)
    elif kind == "reversed":
        from comdb2_tpu_torch.checker.pair_sort import pair_sort_reference

        hi, lo = (t.flip(1).contiguous()
                  for t in pair_sort_reference(hi, lo))
    return hi, lo


STAMP_PHASES = (("load", "levels in registers (k <= E)",
                 "levels up to 32 E (shuffles)",
                 "wider levels (shared memory)", "store"),
                ("co-rank search", "window load", "sub-diagonal search",
                 "serial merge", "store"))


def _stamps(torch, PSORT, build, dev):
    """One sort at (8, 131072) through the -DPS_PROFILE build, queued
    behind a sleep kernel: per launch, when its CTAs enter and finish
    (microseconds from the first CTA of the block sort) and the median
    and largest time of each phase of a CTA."""
    import numpy as np

    lib = build.load("pair_sort", ("PS_PROFILE",))
    B, N = 8, 131072
    hi, lo = (t.to(dev) for t in _rows(B, N, "random", B * N))
    T = lib.pair_sort_tile()
    grid, n = B * N // T, PSORT.launches_per_call(N, T)
    buf = torch.zeros(n * grid * 8, dtype=torch.int64, device=dev)
    PSORT.pair_sort(hi, lo, lib=lib)
    if lib.pair_sort_stamps(buf.data_ptr()):
        raise RuntimeError("pair_sort_stamps failed")
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    PSORT.pair_sort(hi, lo, lib=lib)
    torch.cuda.synchronize()
    lib.pair_sort_stamps(None)
    st = buf.view(n, grid, 8).cpu().numpy()
    t0 = st[0, :, 0].min()
    out = []
    for p in range(n):
        names = STAMP_PHASES[p > 0]
        enter, done = (st[p, :, 0] - t0) / 1e3, (st[p, :, 5] - t0) / 1e3
        span = {}
        for q, name in enumerate(names):
            # a phase the launch skips (no level past 32 E) has no stamp
            d = (st[p, :, q + 1] - st[p, :, q]) / 1e3
            if (st[p, :, q + 1] > 0).all() and (st[p, :, q] > 0).all():
                span[name] = (float(np.median(d)), float(d.max()))
        out.append({"enter_us": [float(enter.min()), float(enter.max())],
                    "finish_us": [float(done.min()), float(done.max())],
                    "phases_us": span})
        label = "block sort" if p == 0 else f"merge pass {p}"
        print(f"stamps {label}: CTAs enter {enter.min():.2f}-"
              f"{enter.max():.2f} us, finish {done.min():.2f}-"
              f"{done.max():.2f} us; per CTA (median / largest): " + "; "
              .join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in span.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--h-wall", action="append", default=[],
                    metavar="ROOT",
                    help="a checkout whose request (h) check_batch wall to "
                         "time (each ROOT in its own process, in the order "
                         "given, e.g. parent, this, this, parent)")
    ap.add_argument("--stamps", action="store_true",
                    help="also time each phase inside each launch of one "
                         "sort at (8, 131072) from a -DPS_PROFILE build")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_pair_sort_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from comdb2_tpu_torch.checker import pair_sort as PSORT
    from comdb2_tpu_torch.kernels import build
    from comdb2_tpu_torch.utils import queued_ms

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(gpu)
    build.build_all()
    if args.stamps:
        build.build("pair_sort", ("PS_PROFILE",))
    lib = build.load("pair_sort")
    attrs = PSORT.kernel_attrs(lib)
    record = {"gpu": gpu, "tile": lib.pair_sort_tile(),
              "smem_bytes": lib.pair_sort_smem_bytes(),
              "kernel_attrs": attrs, "shapes": {}}
    print(f"tile T = {lib.pair_sort_tile()}, dynamic shared memory "
          f"{lib.pair_sort_smem_bytes()} bytes per CTA")
    for kernel, a in attrs.items():
        print(f"  {kernel}: {a['registers']} registers, {a['local_bytes']} "
              f"bytes of spill per thread")
    for B, N in SHAPES:
        for kind in ("random", "equal", "reversed"):
            hi, lo = _rows(B, N, kind, B * N)
            got = PSORT.pair_sort(hi.to(dev), lo.to(dev))
            want = PSORT.pair_sort_reference(hi, lo)
            if not (torch.equal(got[0].cpu(), want[0])
                    and torch.equal(got[1].cpu(), want[1])):
                print(f"torch_pair_sort_profile: the kernel differs from "
                      f"the plain version on {kind} rows {(B, N)}",
                      file=sys.stderr)
                return 1
    print(f"  bit-equal to the plain version on random, all-equal and "
          f"reversed rows at {list(SHAPES)}")

    for B, N in SHAPES:
        hi, lo = (t.to(dev) for t in _rows(B, N, "random", B * N))
        key = (hi.long() << 32) | (lo.long() + 2**31)

        def kernel():
            PSORT.pair_sort(hi, lo)

        def library():
            torch.sort(key, dim=1)

        t_k = [queued_ms(kernel, args.reps)]
        t_l = [queued_ms(library, args.reps), queued_ms(library, args.reps)]
        t_k.append(queued_ms(kernel, args.reps))
        ph = PSORT.phase_ms(hi, lo, args.reps)
        row = {"kernel_ms": t_k, "torch_sort_ms": t_l,
               "launches_per_call": len(ph), "phases_ms": ph}
        record["shapes"][f"{B}x{N}"] = row
        k_ms, l_ms = sum(t_k) / 2, sum(t_l) / 2
        print(f"({B}, {N}): kernel {t_k[0]:.5f} / {t_k[1]:.5f} ms, "
              f"torch.sort on the int64 key {t_l[0]:.5f} / {t_l[1]:.5f} ms "
              f"(in turns: kernel, torch.sort, torch.sort, kernel; "
              f"{l_ms / k_ms:.2f}x); {row['launches_per_call']} launches "
              f"per call")
        print(f"  block sort {ph[0]:.5f} ms, merge passes "
              f"{' '.join(f'{p:.5f}' for p in ph[1:]) or 'none'} "
              f"(sum {sum(ph[1:]):.5f})")

    if args.stamps:
        record["stamps"] = _stamps(torch, PSORT, build, dev)

    for root in args.h_wall:
        r = subprocess.run([sys.executable, "-c", H_WALL, root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        walls = json.loads(r.stdout.strip().splitlines()[-1])
        record.setdefault("h_wall", []).append({"root": root, **walls})
        print(f"request (h) check_batch from {root}: walls "
              f"{' '.join(f'{w:.4f}' for w in walls['walls'])} s (first "
              f"call, then warm); pair_sort calls per request "
              f"{walls['pair_sort_calls']}")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "pair_sort_profile.json"),
              "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
