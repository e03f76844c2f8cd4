#!/usr/bin/env python3
"""Timings and a per-phase cycle profile of the port's segment-search
kernel (``comdb2_tpu_torch/kernels/seg_search.cu``) on one CUDA card.

Run from the root of a checkout on a host with a card:

    python3 scripts/torch_seg_profile.py [--histories 4096]
        [--define RING=8 --define WARP_KEYS=384 --define MIN_CTAS=3 ...]

On ``chip_smoke.py``'s inputs it prints, after the card's name and power
limit:

- CUDA-event times of the kernel as the port builds it: request (a)'s
  head window of 4096 segments and its whole history, the same for (c),
  and request (g)'s stream launch (4096 x 2000 ops; ``--histories``
  smaller for a quicker run), with its warp streams per SM;
- a cycle profile from a build with ``-DSEG_PROFILE``, whose ``clock64()``
  counters add up, for stream 0 of a launch, the cycles of each phase: the
  row-ring waits, the invoke pass, each closure path (no new key; merges
  of new keys sorted 1, 2, 4 or 8 per lane; the shared-memory union), the
  ok filter and whole segments. Profiled: (a)'s head window (one warp
  alone on the card) and the first stream of (g)'s launch (the card
  full). The counters cost cycles of their own, so the profile's
  segment total runs above the plain build's time;
- with ``--define``, the same times through a build with those ``-D``
  macros (``RING``, ``WARP_KEYS`` and ``MIN_CTAS`` size the row ring,
  the warp's key buffer and ``__launch_bounds__``' CTAs per SM, and so
  the warp streams an SM holds), with that build's registers and warp
  streams per SM.

It imports nothing of JAX and falls back to nothing: without a card, or
if a build fails, it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import random
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PHASES = {0: "row-ring wait", 1: "invoke pass", 9: "no new key",
          10: "merge R=1", 11: "merge R=2", 12: "merge R=4",
          13: "merge R=8", 14: "union (shared)", 7: "ok filter",
          8: "segment"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--histories", type=int, default=4096)
    ap.add_argument("--define", action="append", default=[],
                    help="a -D macro of a variant build to time as well")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_seg_profile: needs a CUDA card", file=sys.stderr)
        return 1

    import chip_smoke as CS
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.kernels import build
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import synth_columnar as SC
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import register_history

    dev = torch.device("cuda", 0)
    print(CS._gpu_line())
    singles = {}
    for name, kw in (("a", dict(n_procs=5, seed=42)),
                     ("c", dict(n_procs=10, seed=1010, max_pending=5))):
        seed = kw.pop("seed")
        h = register_history(random.Random(seed), n_events=CS.N_EVENTS,
                             values=5, p_info=0.0, **kw)
        packed = pack_history(h)
        mm = memo(cas_register(), packed)
        singles[name] = (CS._path_inputs(mm, packed, dev)[0],
                         mm.n_transitions)
    cols = SC.register_batch_columns(11_000_000, args.histories, CS.G_OPS,
                                     n_procs=5, values=5)
    batch = TB.pack_batch(SC.pack_register_columns(cols), cas_register(),
                          build_streams=False)
    streams, _ = TB._stream_segments(batch)
    sizes = dict(n_states=batch.memo.n_states,
                 n_transitions=batch.memo.n_transitions)
    spec_g = TB._slice_spec(streams, sizes)
    table_g = torch.from_numpy(SK.pack_table(
        batch.memo.succ[:sizes["n_states"], :sizes["n_transitions"]])).to(dev)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def per_sm(lib):
        n = lib.seg_search_occupancy(ctypes.byref(build.layout(spec_g)),
                                     table_g.numel())
        if n < 1:
            raise RuntimeError("seg_search: no CTA of (g)'s layout fits an "
                               "SM")
        return n

    def g_launch(lib):
        """(g)'s launch through ``lib``, at as many group streams as
        that build holds on the card at once."""
        groups = min(len(streams), sms * per_sm(lib))
        seg, plan, _ = SK.pack_groups(streams, spec_g, groups)
        seg = torch.from_numpy(seg).to(dev)
        n_hist = max(len(g) for g in plan)
        return (lambda: SK.seg_search_stream(
            seg, sizes["n_transitions"], table_g, spec_g, n_hist,
            lib=lib)), groups, n_hist

    def time_build(lib, label):
        for line in build.BUILD_LOG.get("seg_search", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        for name, ((spec, seg, ws, stat, table), stride) in singles.items():
            head = seg[:4096]
            ms_w = CS._time_cuda(lambda: SK._launch(
                head, 0, stride, ws, stat, table, spec, lib=lib), 3)
            ms_f = CS._time_cuda(lambda: SK._launch(
                seg, 0, stride, ws, stat, table, spec, lib=lib), 2)
            print(f"{label} ({name}) [0, 4096): {ms_w:.3f} ms "
                  f"({ms_w * 1e3 / 4096:.3f} µs per segment); whole history "
                  f"({seg.shape[0]} segments padded): {ms_f:.3f} ms")
        run_g, groups, n_hist = g_launch(lib)
        ms_g = CS._time_cuda(run_g, 2)
        print(f"{label} (g) {args.histories} histories: {ms_g:.3f} ms on "
              f"{groups} warp streams ({per_sm(lib)} per SM), at most "
              f"{n_hist} histories per stream")

    build.build_all()
    time_build(build.load(), "plain build")
    if args.define:
        time_build(build.load(defines=tuple(args.define)),
                   f"build -D{' -D'.join(args.define)}")

    # the same launches through the build with the phase counters
    lib = build.load(defines=("SEG_PROFILE",))
    lib.seg_search_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = (ctypes.c_ulonglong * 32)()

    def report(label):
        torch.cuda.synchronize()
        if lib.seg_search_profile(ctypes.addressof(counters), 1):
            raise RuntimeError("seg_search_profile failed")
        print(f"{label} (SEG_PROFILE build, stream 0):")
        for slot, phase in PHASES.items():
            cyc, cnt = counters[slot], counters[slot + 16]
            if cnt:
                print(f"  {phase:15s} {cnt:8d} x {cyc / cnt:9.1f} "
                      f"cycles, {cyc:14d} in all")

    lib.seg_search_profile(ctypes.addressof(counters), 1)
    (spec, seg, ws, stat, table), stride = singles["a"]
    SK._launch(seg[:4096], 0, stride, ws, stat, table, spec, lib=lib)
    report("(a) [0, 4096), one warp alone")
    run_g, groups, _ = g_launch(lib)
    lib.seg_search_profile(ctypes.addressof(counters), 1)
    run_g()
    report(f"(g), the first of {groups} warp streams")
    return 0


if __name__ == "__main__":
    sys.exit(main())
