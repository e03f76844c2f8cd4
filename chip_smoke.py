#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``comdb2_tpu_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds every kernel of the single-history check from the sources in
the checkout, drives the port's main path through its public entry
points (``checker.analysis`` and ``filetest``) on the benchmark
histories at full size, holds every kernel against its plain PyTorch
version on the same card tensors, and times both. It imports nothing
of JAX and nothing of the JAX package, and falls back to nothing: any
failure exits non-zero before the result line.

Requests (histories from ``ops.synth``, seeds as in ``bench.py``):

- (a) 5 processes, 100k events (the 50k-op cas-register history):
  VALID through the kernel;
- (b) the first ``mutate`` seed from 0 up that makes (a) INVALID:
  INVALID with op index and counterexample paths from the kernel's
  chunked boundary;
- (c) 10 processes, max 5 pending, 100k events: VALID;
- (d) 10 processes, max 10 pending, 3000 events: the 16-row, 3-word
  key tier; any verdict (an UNKNOWN shows the overflow path);
- (e) an EDN history file through ``filetest``; checks the exit code.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its parity and times.
A longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_EVENTS = 100_000
WINDOW = 4096          # segments per parity window
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_cuda(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events (one warm-up
    call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _path_inputs(mm, packed, dev):
    """The kernel's inputs exactly as ``analysis`` builds them."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.checker.linear import kernel_slots
    from comdb2_tpu_torch.utils import next_pow2

    segs = LT.make_segments(packed)
    s_real = segs.ok_proc.shape[0]
    segs = LT.make_segments(packed, s_pad=next_pow2(s_real, 64),
                            k_pad=next_pow2(segs.inv_proc.shape[1], 2))
    segs, p_eff = LT.remap_slots(segs)
    prep = SK._prepare(mm.succ, segs, mm.n_states, mm.n_transitions,
                       kernel_slots(p_eff), dev)
    if prep is None:
        raise RuntimeError("kernel gate rejected a benchmark shape")
    return prep, s_real


def _parity(name, mm, packed, dev, record):
    """Kernel vs plain version on the card: a head window of WINDOW
    segments from the initial carry, and a tail window ending at the
    failure (or the last real segment) from the kernel's own carry
    there.
    Returns the head window's (kernel ms, plain ms, work, bytes, spec)
    and the largest absolute difference of (status, fail, n) seen."""
    import torch

    from comdb2_tpu_torch.checker import seg_kernel as SK

    (spec, seg, ws, stat, table), s_real = _path_inputs(mm, packed, dev)
    stride = mm.n_transitions
    full = SK.seg_search(seg, 0, stride, ws, stat, table, spec)
    ms_full = _time_cuda(
        lambda: SK._launch(seg, 0, stride, ws, stat, table, spec), 3)
    S = seg.shape[0]
    end = full[1] + 1 if full[1] >= 0 else s_real
    windows = [(0, min(WINDOW, S))]
    if end > WINDOW:
        windows.append((end - WINDOW, end))
    checked = []
    head = None
    err = 0
    for lo, hi in windows:
        if lo == 0:
            ws0, st0 = ws, stat
        else:
            st_, fa_, n_, ws0 = SK.seg_search(seg[:lo], 0, stride, ws,
                                              stat, table, spec)
            st0 = torch.tensor([st_, fa_, n_, -1], dtype=torch.int32,
                               device=dev)
        part = seg[lo:hi]
        got = SK.seg_search(part, lo, stride, ws0, st0, table, spec)
        work: dict = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = SK.seg_search_reference(part, lo, stride, ws0, st0, table,
                                       spec, work=work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        same = got[:2] == want[:2] and (
            got[0] == SK.UNKNOWN or (got[2] == want[2] and
            SK.decode_frontier(spec, got[3], spec.P)
            == SK.decode_frontier(spec, want[3], spec.P)))
        err = max(err, abs(got[0] - want[0]), abs(got[1] - want[1]),
                  0 if got[0] == SK.UNKNOWN else abs(got[2] - want[2]))
        checked.append({"segments": [lo, hi], "kernel": got[:3],
                        "plain": want[:3], "equal": same})
        if not same:
            raise AssertionError(f"{name}: kernel {got[:3]} != plain "
                                 f"{want[:3]} on segments [{lo}, {hi})")
        if lo == 0:
            ms = _time_cuda(lambda: SK._launch(part, 0, stride, ws0, st0,
                                               table, spec), 5)
            nbytes = 4 * (part.numel() + 2 * ws0.numel() + 2 * st0.numel()
                          + table.numel())
            head = (ms, plain_ms, work, nbytes, spec)
    record["parity"] = {"full_stream": {"segments": S, "real": s_real,
                                        "result": full[:3],
                                        "kernel_ms": ms_full},
                        "windows": checked,
                        "spec": {"P": spec.P, "K": spec.K,
                                 "rows": spec.rows,
                                 "n_words": spec.n_words}}
    print(f"  {name}: parity {'ok' if all(c['equal'] for c in checked) else 'FAIL'}"
          f" on windows {[c['segments'] for c in checked]} of {S} "
          f"segments; full-stream kernel {ms_full:.3f} ms "
          f"(CUDA events, mean of 3); P={spec.P} rows={spec.rows} "
          f"words={spec.n_words}")
    return head, err


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import comdb2_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"comdb2_tpu_torch not found next to this script "
                     f"({e}); run it from the repository root")
    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.checker import analysis, linear_host
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.kernels import build
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    build.build()
    build.load()
    print(f"build: seg_search.cu for sm_90a in "
          f"{time.perf_counter() - t:.1f} s")
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    t = time.perf_counter()
    h_a = register_history(random.Random(42), n_procs=5,
                           n_events=N_EVENTS, values=5, p_info=0.0)
    h_c = register_history(random.Random(1010), n_procs=10,
                           n_events=N_EVENTS, values=5, p_info=0.0,
                           max_pending=5)
    h_d = register_history(random.Random(77), n_procs=10, n_events=3000,
                           values=5, p_info=0.0, max_pending=10)
    h_e = mutate(random.Random(3), register_history(
        random.Random(3), n_procs=5, n_events=2000, values=5,
        p_info=0.0), values=5)
    print(f"histories generated in {time.perf_counter() - t:.1f} s")
    edn_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    edn_path = os.path.join(edn_dir.name, "history.edn")
    with open(edn_path, "w") as fh:
        fh.write(history_to_edn(h_e))
    packed_e = pack_history(h_e)
    want_e = linear_host.check(memo(cas_register(), packed_e),
                               packed_e).valid
    want_rc = 0 if want_e else 1

    # --- the main path, counted ------------------------------------------
    results = {}
    SK.LAUNCHES = 0

    def run(name, h):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = analysis(cas_register(), h)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = {"valid": a.valid, "op_index": a.op_index,
                         "engine": a.info.get("engine"),
                         "effective_slots": a.info.get("effective_slots"),
                         "paths": len(a.info.get("paths", [])),
                         "engines_tried": a.info.get("engines_tried"),
                         "wall_s": wall}
        print(f"request {name}: valid={a.valid!r} op_index={a.op_index} "
              f"engine={a.info.get('engine')} "
              f"slots={a.info.get('effective_slots')} "
              f"paths={len(a.info.get('paths', []))} wall {wall:.3f} s")
        return a

    a = run("a", h_a)
    b_seed, h_b, b = None, None, None
    for seed in range(64):
        cand = mutate(random.Random(seed), h_a, values=5)
        r = run(f"b(seed={seed})", cand)
        if r.valid is False:
            b_seed, h_b, b = seed, cand, r
            break
    c = run("c", h_c)
    d = run("d", h_d)
    t0 = time.perf_counter()
    rc_e = filetest.main([edn_path])
    edn_dir.cleanup()
    results["e"] = {"exit": rc_e, "want": want_rc,
                    "wall_s": time.perf_counter() - t0}
    print(f"request e: filetest exit {rc_e} (want {want_rc})")
    launches = SK.LAUNCHES

    checks = [
        (a.valid is True and a.info.get("engine") == "cuda-seg",
         f"(a) not VALID through cuda-seg: {results['a']}"),
        (b is not None and b.op_index is not None
         and b.info.get("engine") == "cuda-seg"
         and len(b.info.get("paths", [])) > 0,
         "(b) no INVALID with op index and paths from cuda-seg"),
        (c.valid is True and c.info.get("engine") == "cuda-seg",
         f"(c) not VALID through cuda-seg: {results['c']}"),
        (d.info.get("engine") == "cuda-seg"
         and d.info.get("effective_slots", 0) >= 8,
         f"(d) not on the 16-row tier through cuda-seg: {results['d']}"),
        (rc_e == want_rc, f"(e) filetest exit {rc_e}, want {want_rc}"),
        (launches > 0, "the main path launched no kernel"),
    ]
    for ok, msg in checks:
        if not ok:
            return _fail(msg)
    print(f"b: first INVALID mutate seed {b_seed}")
    print(f"LAUNCHES seg_search (main path): {launches}")

    # --- kernel vs plain version on the card ------------------------------
    print(f"parity: kernel vs seg_search_reference, windows of {WINDOW} "
          "segments (head from the initial carry; tail ending at the "
          "failure or the last real segment, from the kernel's carry)")
    head = None
    max_err = 0
    for name, h in (("a", h_a), ("b", h_b), ("c", h_c), ("d", h_d)):
        packed = pack_history(h)
        mm = memo(cas_register(), packed)
        hd, err = _parity(name, mm, packed, dev,
                          results.setdefault(name, {}))
        max_err = max(max_err, err)
        if name == "a":
            head = hd
    tier = results["d"]["parity"]["spec"]
    if (tier["rows"], tier["n_words"]) != (16, 3):
        return _fail(f"(d) did not run the 16-row, 3-word tier: {tier}")
    ms, plain_ms, work, nbytes, spec = head
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = work.get("compare_exchanges", 0) * spec.n_words
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    entry = {"name": "seg_search", "route": "cuda",
             "source": "comdb2_tpu_torch/kernels/seg_search.cu",
             "replaces": "comdb2_tpu/checker/pallas_seg.py:561",
             "launches": launches, "max_abs_err": max_err,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "library_ms": None,
             "parity": "bit-equal (status, fail, n, frontier)",
             "measured_on": f"request (a), segments [0, {WINDOW})"}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"gpu": gpu, "requests": results, "kernels": [entry],
                   "work": work, "bytes": nbytes}, fh, indent=1,
                  default=str)
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "comdb2_tpu")
                    or m.startswith(("jax.", "comdb2_tpu.")))
    if leaked:
        return _fail(f"JAX or the JAX package was imported: {leaked}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
