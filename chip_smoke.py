#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``comdb2_tpu_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds every kernel from the sources in the checkout (one ``nvcc``
per source, all at once), drives the port's main paths through their
public entry points (``checker.analysis``, ``filetest``,
``checker.batch.check_batch`` with every engine, the checker layer's
``txn.check_txn``, ``checker.wl.check_wl_batch`` and
``IndependentChecker``, ``shrink.minimize``, and the streaming
sessions ``stream.StreamSession``, ``stream.engine.MegaBatch``,
``stream.wl`` and ``filetest --follow``) at full size, holds every kernel against
its plain PyTorch version on the same card tensors, and times both. It
imports nothing of JAX and nothing of the JAX package, and falls back
to nothing: any failure exits non-zero before the result line.

Single-history requests (histories from ``ops.synth``, seeds as in
``bench.py``), counted as one path:

- (a) 5 processes, 100k events (the 50k-op cas-register history):
  VALID through the kernel;
- (b) the first ``mutate`` seed from 0 up that makes (a) INVALID:
  INVALID with op index and counterexample paths from the kernel's
  chunked boundary;
- (c) 10 processes, max 5 pending, 100k events: VALID;
- (d) 10 processes, max 10 pending, 3000 events: the kernel (16-row,
  3-word tier) is tried first and overflows; the seg2 capacity ladder
  decides;
- (e) an EDN history file through ``filetest``; checks the exit code;
- (f) a wide history, P = 17 (``wide_register_batch_columns(1009, 1,
  1, 1, 16)``): VALID from the MXU frontier engine at capacity 131072.

Batch requests (``check_batch``), counted as a second path:

- (g) the north star: 4096 histories x 2000 ops
  (``register_batch_packed(11_000_000, ...)``) at F=128, all VALID
  through the stream kernel on at least 132 warp streams (one warp per
  group stream); then ``bench.py``'s 256 x 800-event batch
  (``Random(7)``) at F=256;
- (h) 56 histories: valid and mutated 5-process histories with eight
  8-process histories that overflow the kernel's 128 configs; at
  F=8192 the overflowed lanes escalate through the keys engine (the
  pair-sort kernel); every lane's (status, fail_at) must equal its own
  ``analysis`` on the card. The keys engine, and so the pair sort,
  serves an escalation only when the batch's slot count rounded up to
  a power of two is at most 8 and its key layout fits;
- (h10) 20 histories: 5-process histories with four of request (d)'s
  family (10 processes, up to 10 calls in flight, 600 events) that
  overflow 128 configs; 10 slots round up to 16, so at F=8192 those
  lanes escalate through the MXU frontier engine, not the pair sort;
  every lane must equal its own ``analysis`` on the card.

Every request's verdict, op index, engine and frontier capacity must be
the ones earlier runs of this script recorded (``RECORDED``).

The checker layer, counted as a third path:

- (t) the txn closure at the top of ``scripts/bench_txn.py``: a dense
  dependency graph with its realtime plane at N = 4096 (the generator
  copied here as ``make_graph``), valid and with one rw back edge that
  closes a G2 cycle, realtime on and off, ``cyclic_layers_device``
  bit-equal to the host SCC; then ``closure_diag_batch`` on 8 graphs at
  N = 1024 in one call, each lane bit-equal to the host; card time,
  TFLOP/s and bound of the squarings, beside as many bare
  ``torch.matmul`` calls on (3, N, N) bf16;
- (t2) ``check_txn`` on a ``list_append_history`` of 2400 txns (past
  ``DEVICE_THRESHOLD``, so ``auto`` takes the card), alone and with a
  G1c and a G2-item history appended on fresh processes and keys,
  realtime on and off: verdict maps and decoded cycles equal to
  ``backend="host"``'s, one closure call each;
- (w) ``check_wl_batch`` on 512 lanes per family at the top rungs
  (bank: 512 reads, 512 transfers, 8 accounts; sets: 8000 elements;
  dirty: 8000 values, 512 reads of 16 nodes), valid and with its
  violation twin (``total``, ``lost``, ``dirty``, planted in a copy of
  the valid batch as the generators plant it): one device call per
  batch, every lane agreeing with the host oracle
  (``wl.batch.agrees_with_oracle``); each program's card time, lanes
  per second and bound (bytes read once and written once);
- (i) ``IndependentChecker(Linearizable())`` over 256 keys, each a
  5-process register history of 2000 events, every 32nd mutated: one
  ``seg_search[stream]`` launch, each key's verdict equal to its own
  ``analysis`` on the card;
- (e2) ``filetest --checker txn / bank / sets / dirty`` on every
  fixture under ``tests/fixtures/txn`` and ``tests/fixtures/wl``, and
  ``--checker wgl`` / ``--checker set`` on a register / set history:
  exit codes 0 valid, 1 invalid.

The last batch engines, counted as a fourth path:

- (j) ``check_batch(engine="auto", F=8192)`` on 512 eight-process
  ``register_history`` lanes of 2000 events over 8 values (about 77
  transitions, so only the vmap engine serves the escalation); lanes
  0-7 keep up to 8 calls in flight and overflow the kernel's 128, and
  have one ok value corrupted in their last tenth (four of them turn
  INVALID): the stream kernel, then the vmap engine on the overflowed
  lanes, VALID and INVALID mixed. Every lane equal to its own
  ``analysis`` on the card, the escalated ones also to ``linear_host``;
  the escalation's wall and card span and the vmap engine's host syncs.
  After the counts, the group streams of lanes 0-7 (and two more) of
  (j)'s own launch are held bit-equal against the plain stream version;
- (j2) (h)'s 48 five-process histories at F=8192 through
  ``engine="flat"``, ``"vmap"`` and ``"keys"``: flat and vmap equal
  keys in status and fail index, and in ``n_final`` on VALID lanes;
  each engine's card span (CUDA events) and wall, closure iterations,
  host syncs, CUDA kernels per closure iteration (``torch.profiler`` on
  a prefix of the run) and bytes bound (frontier rows read and written
  once per iteration). The widest rows that keys sorted here are held
  bit-equal against ``pair_sort_reference``.

Counterexample shrink, counted as a fifth path:

- (s10) ``scripts/bench_shrink.py``'s register seeds at 10k events (a
  3-process write-only history, read-only for lost-update, with
  ``inject_anomaly``'s stale-read or lost-update planted at its end;
  the generators copied here as ``register_seed`` and ``make_ring``):
  ``shrink.minimize(checker="linear", F=1024, engine="auto")`` on the
  card, one ``seg_search[stream]`` launch per ddmin round; the minimal
  ops must be the injected truth, ``one_minimal`` true, the
  1-minimality certificate re-derived on the host with ``linear_host``,
  ``render_minimal`` INVALID, and rounds / candidates / dispatches
  those recorded (``RECORDED_SHRINK``). After the counts, the first
  ddmin round's launch is held bit-equal against the plain stream
  version;
- (s) the same at 100k events, with the wall, the stream launches, the
  card time summed over them (CUDA events) and the host split of every
  round (the port's trace spans: ``shrink.pack``, ``batch.remap``,
  ``batch.dispatch``, ``batch.finalize``);
- (st) ``minimize(checker="txn")`` on (t2)'s 2400-txn base with a
  write-skew ring (``-T``) and a dirty-commit ring (``-R``) appended:
  the seed closure at the 4096 bucket, then ``closure_diag_batch`` per
  round; every field equal to ``RECORDED_TXN``, the closure's card time
  per round;
- (sf) ``filetest --shrink --store`` on the shrink and txn fixtures:
  exit 1, ``minimal.edn`` / ``results.edn`` / ``shrink.svg`` written,
  certified, re-checked INVALID, and ``filetest`` on ``minimal.edn``
  exits 1; on ``clean.edn`` exit 0 and the seed rejected;
- (sa) the checker objects' store artifacts: ``Linearizable`` on (b)
  (``linear.svg``), ``Serializable`` on (t2)'s G1c history
  (``serializable.txt`` / ``.svg``), ``IndependentChecker`` on (i)'s
  256 keys (every key's ``results.edn`` and ``history.edn``, and
  ``linear.svg`` for the INVALID keys); each ``results.edn`` reads back
  equal to the returned map.

Streaming sessions, counted as a sixth path (``stream``; every session
on the card with ``device=None``, each verdict held to its one-shot
oracle after the path's counts):

- (v1) (a)'s 100k events appended live in 256-event deltas (391
  appends) to one ``StreamSession("cas-register")``: ``auto`` keeps the
  kernel rung, one launch and one host sync per append; verdict equal
  to (a)'s; per-append wall (median, p99, first- and last-quarter
  means), card time per append (CUDA events around each launch), host
  syncs, dispatches, carry bytes, the card's idle share, and
  ``analysis`` of the prefix from scratch at 25 / 50 / 75 / 100%;
- (v2) (b) streamed the same way: it latches at (b)'s op index, the
  appends after the latch dispatch nothing, ``counterexample()``
  equals (b)'s configs and paths;
- (v3) (d) in 64-event deltas: one kernel overflow at 128, one replay
  onto the xla rung, in-place escalation; VALID as (d);
- (v4) (f) through the MXU rung, escalating in place to 131072;
- (v5) 16 sessions of (i)'s keys in 128-event beats, one ``MegaBatch``
  per beat (16 launches, one readback), then 4 xla-rung and 4
  mxu-rung lanes forced with ``engine=``: one call per beat, carries
  and verdicts bit-equal to the same sessions run solo;
- (v6) bank (512 reads, 512 transfers, 8 accounts) and sets (8000
  elements) sessions with their ``total`` / ``lost`` twins, in deltas,
  equal to ``check_wl_batch`` on the whole history; a 16-lane bank
  megabatch bit-equal to solo;
- (v7) (v1) checkpointed at 50% through ``to_wire`` / ``from_wire``,
  restored on the card and on the CPU, both finishing equal to (v1);
- (v8) ``filetest --follow`` on (e)'s history written by a writer
  thread in 10 pieces, the last line unterminated: exit code and
  verdict equal to ``filetest`` on the whole file;
- (v9), after the counts: every launch of (v1)'s first 16 appends and
  each lane of one fused (v5) beat bit-equal to
  ``seg_search_reference`` on the same card tensors.

In the single-history path, (e3) is (e) again with ``filetest --trace``:
the span totals per stage (parse, pack, device with segments / kernel /
decode inside, finalize) and the parser that ran — the C++ loader when
``native/build/libct_sut.so`` is built (the script builds it with
``cmake`` at its start when it is missing and ``cmake`` is there), else
the Python reader.

Then: (d') the seg2 engine on the card against the same engine on CPU
tensors on history (d)'s first ``D_PRIME`` = 512 segments (the card
also runs all 2048); kernel parity on the card for ``seg_search``
(windows of (a)-(d); the 64-segment stretch of (c)'s head window whose
closures are the largest, found by the plain version; and
``concurrent_writes(k)`` histories whose closures take the kernel's
rarest paths, its widest register merges and its shared-memory union
sort), ``seg_search[stream]`` (request (h)'s whole
launch, two of request (g)'s own group streams launched together at
(g)'s layout, one group stream of nine (h) histories with an INVALID
and an overflowing one in the middle, and SMs x 8 copies of a group
stream whose largest closures take the CTA's locked buffer, 8 warps to
a CTA) and ``pair_sort`` (the
widest rows the keys engine sorted in (h), random rows at the block-sort
and the merge-pass widths, all-equal and reversed rows, corner words,
rows of one tile, two tiles and one pair). The pair sort is timed in
turns with ``torch.sort`` on the int64 key (kernel, library, library,
kernel), queued behind a sleep kernel and back to back, and its launches
one by one (block sort, merge passes); its registers are read from the
loaded library.

Each kernel's bound counts what its function needs on this run's
inputs: bytes read once and written once at the HBM rate, and
comparisons of int32 words at the card's int32 rate, 64 INT32 lanes per
SM x SMs x the maximum SM clock. For ``seg_search`` the comparisons are
``seg_kernel.needed_compares``: per closure iteration over n sorted
frontier keys, one binary search of ceil(log2(n + 1)) for each of the
n P expansions, and u ceil(log2 u) to sort the u keys it added; the
kernel's own ``need`` counter is held equal to that count wherever the
plain version runs, and gives it for (g), where it does not. For
``pair_sort``, N floor(log2 N) comparisons per row.

It prints the kernel's schedule on the way: µs per segment and per
closure iteration, the histogram of closure sizes M = next_pow2(n (P +
1)) over (a)'s head window, and for (g) the warp streams per SM, the
group count G and the most histories one stream runs.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its parity and times, and
its launches on each path (``launches_by_path``).
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
INT32_LANES_PER_SM = 64              # Hopper's INT32 units per SM
G_HISTORIES, G_OPS = 4096, 2000      # (g), the batch north star
MIN_STREAMS = 132                    # the H100's SM count
DEEP = 64              # segments of (c)'s deepest stretch
D_PRIME = 512          # (d)'s segments that (d') runs on CPU tensors too
BF16_FLOPS = 989e12    # the H100's dense bf16 tensor-core peak (SXM)
CLOSURE_N, CLOSURE_BATCH, CLOSURE_BATCH_N = 4096, 8, 1024   # (t)
TXN_COUNT = 2400       # (t2): past check_txn's DEVICE_THRESHOLD
WL_LANES = 512         # (w): the top WL_BATCH rung
KEYS, KEY_EVENTS = 256, 2000                                 # (i)
J_LANES, J_EVENTS, J_OVERFLOW, J_F = 512, 2000, 8, 8192     # (j), (j2)
S10_EVENTS, S_EVENTS, SHRINK_F = 10_000, 100_000, 1024      # (s10), (s)
# (s10): (rounds, candidates, dispatches) of the JAX package's
# minimize(checker="linear", F=1024, engine="auto") on CPU, where its
# auto engine is keys at F = 1024 (the port's stream kernel at 128,
# escalating to keys at 1024, has the same capacity); (s): the first
# card run of this script's fifth path, which the JAX package on CPU
# matched afterwards (in 964 and 669 s)
RECORDED_SHRINK = {("s10", "stale-read"): (15, 28, 14),
                   ("s10", "lost-update"): (15, 29, 15),
                   ("s", "stale-read"): (18, 34, 17),
                   ("s", "lost-update"): (18, 35, 18)}
# (st): the JAX package's minimize(checker="txn") on CPU, for -T and -R
# alike: the ring's 8 txns (node ids after the 2400-txn base) and the
# audit read as evidence; the ops are the 18 of make_ring, in order
RECORDED_TXN = {"txns": list(range(2400, 2408)), "evidence_txns": [2408],
                "anomaly_class": "G2-item", "seed_class": "G2-item",
                "rounds": 5, "candidates": 34, "dispatches": 5}
# what earlier runs of this script recorded on the card (PERF.md): per
# request (valid, op_index, engine, frontier capacity), None where not
# pinned; statuses per batch
RECORDED = {
    "a": (True, None, "cuda-seg", 128),
    "b": (False, 68941, "cuda-seg", 128),
    "c": (True, None, "cuda-seg", 128),
    "d": (True, None, "torch-seg2", 8192),
    "f": (True, None, "mxu-frontier", 131072),
}
RECORDED_BATCHES = {"g": {0: G_HISTORIES}, "g2": {0: 256}, "h": {0: 50, 1: 6},
               "h10": {0: 15, 1: 5}}


class _MRecorder(dict):
    """A ``work`` dict for ``seg_search_reference`` that also keeps the
    key count m of every closure iteration, in order (its increments of
    ``work["keys"]``)."""

    def __init__(self):
        super().__init__()
        self.ms = []

    def __setitem__(self, key, value):
        if key == "keys":
            self.ms.append(value - self.get("keys", 0))
        super().__setitem__(key, value)


def _m_histogram(ms):
    """Closure iterations by M = next_pow2(m), m = n (P + 1) keys."""
    by_m = {}
    for m in ms:
        M = 1 << max(m - 1, 0).bit_length()
        by_m[M] = by_m.get(M, 0) + 1
    return dict(sorted(by_m.items()))


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
        work = _MRecorder()
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
            need = torch.zeros(1, dtype=torch.int64, device=dev)
            SK._launch(part, 0, stride, ws0, st0, table, spec, need=need)
            if int(need) != SK.needed_compares(work.ms, spec.P):
                raise AssertionError(
                    f"{name}: the kernel's need {int(need)} != "
                    f"{SK.needed_compares(work.ms, spec.P)}")
            nbytes = 4 * (part.numel() + 2 * ws0.numel() + 2 * st0.numel()
                          + table.numel())
            head = (ms, plain_ms, work, nbytes, spec)
            live = int((part[:, 0] >= 0).sum())
            by_m = _m_histogram(work.ms)
            record["schedule"] = {
                "segments": hi, "live_segments": live,
                "iterations": len(work.ms), "us_per_segment":
                    ms * 1e3 / max(live, 1),
                "us_per_iteration": ms * 1e3 / max(len(work.ms), 1),
                "M_histogram": by_m, "compares": work.get("compares", 0),
                "need": int(need)}
            print(f"  {name} head window: {ms:.3f} ms, "
                  f"{ms * 1e3 / max(live, 1):.3f} µs per live segment "
                  f"({live}), {ms * 1e3 / max(len(work.ms), 1):.3f} µs per "
                  f"closure iteration ({len(work.ms)}); closure sizes M = "
                  f"next_pow2(n (P+1)): {by_m}; comparisons: "
                  f"{work.get('compares', 0)} counted by the plain version, "
                  f"{int(need)} needed")
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


def _deep_window(mm, packed, dev, record):
    """The DEEP-segment stretch of the head window whose closures are
    the largest, found by the plain version run in stretches through its
    own carry; then the kernel on that stretch from its own carry, held
    bit-equal to the plain version. Returns the stretch's largest
    closure m and the kernel's largest (status, fail, n) difference."""
    import torch

    from comdb2_tpu_torch.checker import seg_kernel as SK

    (spec, seg, ws, stat, table), _ = _path_inputs(mm, packed, dev)
    stride = mm.n_transitions
    carry_ws, carry_st = ws, stat
    best_m, best_lo = -1, 0
    for lo in range(0, min(WINDOW, seg.shape[0]), DEEP):
        rec = _MRecorder()
        st_, fa_, n_, carry_ws = SK.seg_search_reference(
            seg[lo:lo + DEEP], lo, stride, carry_ws, carry_st, table, spec,
            work=rec)
        carry_st = torch.tensor([st_, fa_, n_, -1], dtype=torch.int32,
                                device=dev)
        if rec.ms and max(rec.ms) > best_m:
            best_m, best_lo = max(rec.ms), lo
        if st_ != SK.VALID:
            break
    lo, hi = best_lo, best_lo + DEEP
    st_, fa_, n_, ws0 = SK.seg_search(seg[:lo], 0, stride, ws, stat, table,
                                      spec)
    st0 = torch.tensor([st_, fa_, n_, -1], dtype=torch.int32, device=dev)
    part = seg[lo:hi]
    got = SK.seg_search(part, lo, stride, ws0, st0, table, spec)
    rec = _MRecorder()
    want = SK.seg_search_reference(part, lo, stride, ws0, st0, table, spec,
                                   work=rec)
    same = got[:3] == want[:3] and (SK.decode_frontier(spec, got[3], spec.P)
                                    == SK.decode_frontier(spec, want[3],
                                                          spec.P))
    ms = _time_cuda(lambda: SK._launch(part, lo, stride, ws0, st0, table,
                                       spec), 5)
    by_m = _m_histogram(rec.ms)
    record["deep_window"] = {"segments": [lo, hi], "kernel": got[:3],
                             "plain": want[:3], "equal": same,
                             "max_m": max(rec.ms), "M_histogram": by_m,
                             "kernel_ms": ms}
    print(f"  c deepest stretch [{lo}, {hi}): parity "
          f"{'ok' if same else 'FAIL'}, largest closure m={max(rec.ms)}, "
          f"closure sizes {by_m}; kernel {ms:.3f} ms")
    if not same:
        raise AssertionError(f"(c) deepest stretch: kernel {got[:3]} != "
                             f"plain {want[:3]} on [{lo}, {hi})")
    if max(rec.ms) <= 512:
        raise AssertionError("(c)'s deepest stretch has no closure past "
                             "512 keys")
    err = max(abs(got[0] - want[0]), abs(got[1] - want[1]),
              abs(got[2] - want[2]))
    return max(rec.ms), err


def _rare_paths(dev, record):
    """The kernel on ``concurrent_writes(k)``: merges of 4 and 8 new keys
    per lane (k = 6, 7) and the union path, more than 256 new
    candidates sorted in the CTA's locked buffer (k = 8, with 2-word and,
    at P = 15, 3-word keys), to the overflow; held bit-equal to the plain
    version, frontier included. Returns the largest difference."""
    import torch

    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import concurrent_writes

    err, rows = 0, []
    for k, P in ((6, 1), (7, 1), (8, 1), (8, 15)):
        packed = pack_history(concurrent_writes(k), completed=True)
        mm = memo(cas_register(), packed)
        segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
        spec = SK.spec_for(mm.n_states, mm.n_transitions, max(p, P), 8)
        args = [torch.from_numpy(a).to(dev) for a in (
            SK.pack_segments(segs, spec), SK.initial_frontier(spec),
            SK._init_stat(), SK.pack_table(mm.succ))]
        seg, ws, stat, table = args
        got = SK.seg_search(seg, 0, mm.n_transitions, ws, stat, table, spec)
        want = SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat,
                                       table, spec)
        same = got[:3] == want[:3] and (
            SK.decode_frontier(spec, got[3], spec.P)
            == SK.decode_frontier(spec, want[3], spec.P))
        rows.append({"k": k, "P": spec.P, "words": spec.n_words,
                     "kernel": got[:3], "plain": want[:3], "equal": same})
        if not same:
            raise AssertionError(f"concurrent_writes({k}) P={spec.P}: "
                                 f"kernel {got[:3]} != plain {want[:3]}")
        err = max(err, *(abs(a - b) for a, b in zip(got[:3], want[:3])))
    record["rare_paths"] = rows
    print(f"  rare paths (concurrent writes, k = 6, 7, 8, 8 at P = 15): "
          f"bit-equal {[(r['k'], r['words'], r['kernel']) for r in rows]}")
    return err


def _contended_union(dev, record):
    """The stream kernel with every warp of every CTA competing for its
    CTA's locked large-closure buffer: SMs x 8 copies of one group
    stream, ``concurrent_writes(8)`` twice and then a (c)-family history
    (closures of up to 864 keys at P = 8), so the launch runs 8 warps to
    a CTA. Every stream's results, work and need must equal the plain
    version's on that group. Returns the largest difference."""
    import torch

    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import concurrent_writes, register_history

    rng = random.Random(1010)
    c_hist = [register_history(rng, n_procs=10, n_events=300, values=5,
                               p_info=0.0, max_pending=5)
              for _ in range(2)][1]
    cw = pack_history(concurrent_writes(8), completed=True)
    tb = TB.pack_batch([cw, cw, c_hist], cas_register())
    streams, _ = TB._stream_segments(tb)
    stride = tb.memo.n_transitions
    spec = TB._slice_spec(streams, dict(n_states=tb.memo.n_states,
                                        n_transitions=stride))
    one, _, _ = SK.pack_groups(streams, spec, 1)
    table = torch.from_numpy(SK.pack_table(tb.memo.succ)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = sms * SK.WARPS_PER_CTA
    seg = torch.from_numpy(one).to(dev).expand(G, *one.shape[1:]).contiguous()
    work = torch.zeros(G, dtype=torch.int64, device=dev)
    need = torch.zeros_like(work)
    got = SK.seg_search_stream(seg, stride, table, spec, 3, work=work,
                               need=need)
    torch.cuda.synchronize()
    want = torch.zeros((3, 3), dtype=torch.int32, device=dev)
    rec = _MRecorder()
    SK.seg_search_reference(seg[0], 0, stride,
                            torch.from_numpy(SK.initial_frontier(spec)).to(dev),
                            torch.from_numpy(SK._init_stat()).to(dev), table,
                            spec, work=rec, results=want)
    geometry = SK.launch_geometry(G, sms)
    same = (bool((got == want).all()) and bool((work == rec["compares"]).all())
            and bool((need == SK.needed_compares(rec.ms, spec.P)).all()))
    record["contended_union"] = {
        "streams": G, "launch_geometry": geometry, "P": spec.P,
        "max_m": max(rec.ms), "plain": want.tolist(), "equal": same}
    print(f"  stream, every warp of {geometry[0]} CTAs x {geometry[1]} "
          f"warps on the locked union (closures up to m={max(rec.ms)}, "
          f"P={spec.P}): {'bit-equal' if same else 'DIFFERENT'} (status, "
          f"fail, n), work and need")
    if not same or geometry[1] != SK.WARPS_PER_CTA or max(rec.ms) <= 512:
        raise AssertionError(
            f"contended union: {record['contended_union']}")
    return int((got.long() - want.long()).abs().max())


def _int32_ops_per_s(dev) -> float:
    """The card's int32 rate: INT32 lanes per SM x SMs x the maximum SM
    clock that ``nvidia-smi`` reports."""
    import torch

    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    mhz = float(r.stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def _bound(nbytes: float, ops: float, int32_rate: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    int32 operations over the card's int32 rate."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / int32_rate * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _h_histories():
    """(h): 48 five-process histories (every third mutated) with eight
    8-process histories (up to 8 calls in flight) that overflow 128
    configs, spread through the batch. Eight slots are the most the
    keys engine, and so the pair sort, takes: a batch whose slot count
    rounds up to 16 escalates through the MXU engine instead (h10)."""
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    rng = random.Random(5)
    hs = []
    for i in range(48):
        h = register_history(rng, n_procs=5, n_events=1000, values=5,
                             p_info=0.0)
        hs.append(mutate(rng, h, values=5) if i % 3 == 1 else h)
    for j, seed in enumerate((0, 1, 3, 4, 5, 7, 8, 10)):
        hs.insert(3 + 7 * j, register_history(
            random.Random(seed), n_procs=8, n_events=400, values=5,
            p_info=0.0, max_pending=8))
    return hs


def _h10_histories():
    """(h10): 16 five-process histories (every third mutated) with four
    of request (d)'s family — 10 processes, up to 10 calls in flight —
    that overflow 128 configs, spread through the batch."""
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    rng = random.Random(10)
    hs = []
    for i in range(16):
        h = register_history(rng, n_procs=5, n_events=1000, values=5,
                             p_info=0.0)
        hs.append(mutate(rng, h, values=5) if i % 3 == 1 else h)
    for j, seed in enumerate((77, 78, 79, 80)):
        hs.insert(2 + 5 * j, register_history(
            random.Random(seed), n_procs=10, n_events=600, values=5,
            p_info=0.0, max_pending=10))
    return hs


def _lanes_vs_analysis(hs, st, fa):
    """Each batch lane's (status, fail_at) beside its own single-history
    ``analysis`` on the card; returns the lanes and the mismatched
    indices."""
    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.model import cas_register

    lanes = []
    for i, h in enumerate(hs):
        r = analysis(cas_register(), h)
        want = ({True: LT.VALID, False: LT.INVALID}.get(r.valid,
                                                          LT.UNKNOWN),
                -1 if r.valid is True else r.op_index)
        lanes.append((int(st[i]), int(fa[i]), want))
    return lanes, [i for i, (s_, f_, w) in enumerate(lanes)
                   if (s_, f_) != w]


class _Failed(Exception):
    """A check of the checker-layer path failed."""


def _expect(ok: bool, msg: str) -> None:
    if not ok:
        raise _Failed(msg)


def make_graph(rng: random.Random, n: int, dense: bool):
    """(4, n, n) bool planes of a plausible dependency graph (the
    generator of ``scripts/bench_txn.py``): a serial order with local
    ww/wr/rw edges (acyclic, so the closure runs to full depth), plus
    the dense realtime plane when asked (about n^2 / 2 edges)."""
    import numpy as np

    adj = np.zeros((4, n, n), dtype=bool)
    for i in range(n):
        for _ in range(2):
            j = i + rng.randint(1, 6)
            if j < n:
                adj[rng.randrange(3), i, j] = True
        if rng.random() < 0.1:
            j = rng.randrange(n)
            if j > i:
                adj[2, i, j] = True
    if dense:
        ends = np.cumsum(rng.choices([1, 2], k=n))
        starts = ends - rng.choices([1, 3, 8], k=n)
        adj[3] = starts[None, :] > ends[:, None]
        np.fill_diagonal(adj[3], False)
    return adj


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _closure_requests(dev, rec):
    """(t): the closure at the top of the bench, N = 4096, dense with
    the realtime plane, valid and with one back edge closing a G2
    cycle, realtime on and off, each bit-equal to the host SCC; then 8
    graphs at N = 1024 in one batched call."""
    import numpy as np
    import torch

    from comdb2_tpu_torch.txn import closure_torch as TCL
    from comdb2_tpu_torch.txn.scc import cyclic_layers_host

    n = CLOSURE_N
    t0 = time.perf_counter()
    adj = make_graph(random.Random(4096), n, dense=True)
    # an rw edge back to txn 0 from the last txn that txn 0 reaches
    # through ww / wr / rw edges closes a cycle that needs the rw plane
    # (G2-item), with the realtime plane and without it
    reach = np.zeros(n, bool)
    reach[0] = True
    frontier = reach.copy()
    deps = adj[0] | adj[1] | adj[2]
    while frontier.any():
        frontier = deps[frontier].any(0) & ~reach
        reach |= frontier
    cyc = adj.copy()
    cyc[2, int(np.flatnonzero(reach)[-1]), 0] = True
    t_gen = time.perf_counter() - t0
    runs = []
    for label, a in (("valid", adj), ("back edge", cyc)):
        for realtime in (True, False):
            t0 = time.perf_counter()
            host = cyclic_layers_host(a, realtime=realtime)
            t_host = time.perf_counter() - t0
            d0 = TCL.DISPATCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = TCL.cyclic_layers_device(a, realtime=realtime, device=dev)
            wall = time.perf_counter() - t0
            same = bool(np.array_equal(got, host))
            runs.append({"graph": label, "realtime": realtime,
                         "equal": same, "calls": TCL.DISPATCHES - d0,
                         "cyclic_per_layer": host.sum(1).tolist(),
                         "wall_s": wall, "host_s": t_host})
            print(f"  t {label}, realtime {realtime}: closure_diag "
                  f"{'bit-equal' if same else 'DIFFERENT'} to the host SCC, "
                  f"cyclic per layer {host.sum(1).tolist()}; wall "
                  f"{wall * 1e3:.1f} ms (pack, upload, squarings, readback), "
                  f"host SCC {t_host:.2f} s")
            _expect(same and TCL.DISPATCHES - d0 == 1,
                    f"(t) closure_diag differs from the host SCC or took "
                    f"{TCL.DISPATCHES - d0} calls: {runs[-1]}")
    _expect(not runs[0]["cyclic_per_layer"][2]
            and runs[2]["cyclic_per_layer"][2] > 0
            and runs[3]["cyclic_per_layer"][2] > 0,
            f"(t) the back edge did not close a G2 cycle: {runs}")
    # card time of the device program alone (planes already uploaded)
    planes = torch.from_numpy(TCL._pack(adj)).to(dev)
    sq = TCL.squarings(n)
    ms = _time_cuda(lambda: TCL._diag_kernel(planes, n), 5)
    gb = (torch.rand(3, n, n, device=dev) < 0.5).to(torch.bfloat16)
    lib_ms = _time_cuda(lambda: [torch.matmul(gb, gb) for _ in range(sq)],
                        5)
    flops = 3 * 2 * n ** 3 * sq
    bound, by = _bound_flops(_nbytes([planes]) + 3 * n, flops)
    kernels = _count_kernels(lambda: TCL._diag_kernel(planes, n))
    print(f"  t closure N={n}: {sq} squarings of (3, {n}, {n}) bf16, "
          f"{ms:.3f} ms on the card (CUDA events, warm, mean of 5), "
          f"{flops / ms / 1e9:.1f} TFLOP/s; {sq} bare torch.matmul "
          f"{lib_ms:.3f} ms; bound {bound:.4f} ms ({by}, {BF16_FLOPS:.3g} "
          f"FLOP/s bf16); {kernels} CUDA kernels per call")
    # the batched entry: 8 graphs at N = 1024, one call
    nb = CLOSURE_BATCH_N
    rng = random.Random(1024)
    adjs = np.stack([make_graph(rng, nb, dense=True)
                     for _ in range(CLOSURE_BATCH)])
    for b in range(1, CLOSURE_BATCH, 2):
        adjs[b, 2, nb - 1 - b, b] = True       # a back edge in every odd lane
    d0 = TCL.DISPATCHES
    t0 = time.perf_counter()
    got_b = TCL.closure_diag_batch(adjs, device=dev)
    wall_b = time.perf_counter() - t0
    calls_b = TCL.DISPATCHES - d0
    host_b = [cyclic_layers_host(adjs[b], realtime=True)
              for b in range(CLOSURE_BATCH)]
    same_b = [bool(np.array_equal(got_b[b], host_b[b]))
              for b in range(CLOSURE_BATCH)]
    planes_b = torch.from_numpy(TCL._pack(adjs)).to(dev)
    sq_b = TCL.squarings(nb)
    ms_b = _time_cuda(lambda: TCL._diag_kernel(planes_b, nb), 5)
    gbb = (torch.rand(CLOSURE_BATCH, 3, nb, nb, device=dev)
           < 0.5).to(torch.bfloat16)
    lib_b = _time_cuda(lambda: [torch.matmul(gbb, gbb)
                                for _ in range(sq_b)], 5)
    flops_b = CLOSURE_BATCH * 3 * 2 * nb ** 3 * sq_b
    bound_b, by_b = _bound_flops(_nbytes([planes_b])
                                 + CLOSURE_BATCH * 3 * nb, flops_b)
    print(f"  t batch {CLOSURE_BATCH} x N={nb}: {calls_b} call, lanes "
          f"{'bit-equal' if all(same_b) else same_b} to the host SCC, "
          f"cyclic lanes {[int(h.any()) for h in host_b]}; {ms_b:.3f} ms "
          f"on the card, {flops_b / ms_b / 1e9:.1f} TFLOP/s; bare "
          f"torch.matmul {lib_b:.3f} ms; bound {bound_b:.4f} ms ({by_b}); "
          f"wall {wall_b * 1e3:.1f} ms")
    _expect(all(same_b) and calls_b == 1,
            f"(t) closure_diag_batch: lanes {same_b}, {calls_b} calls")
    _expect([bool(h.any()) for h in host_b]
            == [bool(b % 2) for b in range(CLOSURE_BATCH)],
            "(t) the batch's back edges did not close cycles")
    rec["t"] = {"generate_s": t_gen, "runs": runs, "N": n, "squarings": sq,
                "program": {
                    "name": "closure_diag", "ms": ms, "library_ms": lib_ms,
                    "bound_ms": bound, "bound_by": by, "flops": flops,
                    "tflop_s": flops / ms / 1e9, "cuda_kernels": kernels,
                    "calls_per_request": 1},
                "batch": {
                    "name": "closure_diag_batch", "B": CLOSURE_BATCH,
                    "N": nb, "ms": ms_b, "library_ms": lib_b,
                    "bound_ms": bound_b, "bound_by": by_b, "flops": flops_b,
                    "tflop_s": flops_b / ms_b / 1e9, "wall_s": wall_b,
                    "calls_per_request": calls_b, "equal": same_b}}


def _bound_flops(nbytes: float, flops: float):
    """(bound_ms, bound_by) at the HBM rate and the bf16 peak."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = flops / BF16_FLOPS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _count_kernels(fn):
    """CUDA kernels one call of ``fn`` launches, by ``torch.profiler``
    (None when the profiler sees no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    except Exception as e:               # measurement only, never a gate
        print(f"  (torch.profiler: {type(e).__name__}: {e})")
        return None
    return n or None


def _fresh(history, offset):
    """A txn history on processes and keys ``offset`` apart."""
    return [op.with_(process=op.process + offset,
                     value=tuple((f, k + offset, v) for f, k, v in op.value))
            for op in history]


def _check_txn_requests(dev, rec):
    """(t2): ``check_txn`` end to end on a list-append run of 2400 txns
    (``auto`` takes the card), alone and with a G1c and a G2-item
    history appended on fresh processes and keys; verdict maps and
    decoded cycles equal to the host backend's, realtime on and off."""
    import torch

    from comdb2_tpu_torch.ops.synth import (list_append_history,
                                             txn_anomaly_history)
    from comdb2_tpu_torch.txn import check_txn
    from comdb2_tpu_torch.txn import closure_torch as TCL

    t0 = time.perf_counter()
    base = list_append_history(random.Random(2048), n_procs=16,
                               n_txns=TXN_COUNT, n_keys=64, max_micro=4)
    t_gen = time.perf_counter() - t0
    out = []
    for label, extra in (("valid", None), ("+g1c", "g1c"),
                         ("+g2-item", "g2-item")):
        h = base if extra is None else \
            base + _fresh(txn_anomaly_history(extra), 10_000)
        for realtime in (False, True):
            d0 = TCL.DISPATCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = check_txn(h, realtime=realtime, device=dev)
            wall = time.perf_counter() - t0
            calls = TCL.DISPATCHES - d0
            t0 = time.perf_counter()
            want = check_txn(h, backend="host", realtime=realtime)
            t_host = time.perf_counter() - t0
            cex = got["counterexample"]
            row = {"history": label, "realtime": realtime,
                   "txns": got["txn-count"], "edges": got["edge-count"],
                   "valid": got["valid?"],
                   "class": cex and cex["class"],
                   "cycle": cex and [s["txn"] for s in cex["cycle"]],
                   "equal": got == want, "calls": calls, "wall_s": wall,
                   "host_s": t_host}
            out.append(row)
            print(f"  t2 {label}, realtime {realtime}: {row['txns']} txns, "
                  f"{row['edges']} edges, valid={got['valid?']!r} "
                  f"class={row['class']} cycle={row['cycle']}; "
                  f"{'equal to' if row['equal'] else 'DIFFERENT from'} "
                  f"backend=host; wall {wall:.3f} s ({calls} closure call), "
                  f"host {t_host:.3f} s")
            _expect(row["equal"] and calls == 1,
                    f"(t2) check_txn on the card differs from the host or "
                    f"did not take the card: {row}")
            want_class = {None: None, "g1c": "G1c",
                          "g2-item": "G2-item"}[extra]
            _expect(row["class"] == want_class
                    and got["valid?"] is (extra is None),
                    f"(t2) {label}: verdict {got['valid?']!r}, class "
                    f"{row['class']} (want {want_class})")
    rec["t2"] = {"generate_s": t_gen, "runs": out}


def _plant(family, histories):
    """The violation twin of a valid ``wl.synth`` batch, planted in a
    copy of each lane's last read, as the generators plant it: bank
    ``total`` (+1 on the first balance, so the total breaks), sets
    ``lost`` (an acked element dropped from the final read), dirty
    ``dirty`` (a failed write's value on the last node)."""
    out = []
    for h in histories:
        h = list(h)
        ri = max(i for i, op in enumerate(h)
                 if op.type == "ok" and op.f == "read")
        row = list(h[ri].value)
        if family == "bank":
            row[0] += 1
            h[ri - 1] = h[ri - 1].with_(value=tuple(row))
        elif family == "sets":
            acked = next(op.value for op in h
                         if op.type == "ok" and op.f == "add")
            row.remove(acked)
        else:
            row[-1] = next(op.value for op in h
                           if op.type == "fail" and op.f == "write")
        h[ri] = h[ri].with_(value=tuple(row))
        out.append(h)
    return out


def _wl_requests(dev, rec):
    """(w): the three families at the top rungs, 512 lanes each, valid
    and with their violation twins; every lane against the host oracle,
    one device call per batch; the device program timed alone."""
    import torch

    from comdb2_tpu_torch import convert
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.checker.wl import batch as WB

    specs = {
        "bank": (lambda: W.bank_batch(1, WL_LANES, n_accounts=8,
                                       n_transfers=512, n_reads=512),
                 "total"),
        "sets": (lambda: (W.sets_batch(2, WL_LANES, n_adds=8000), None),
                 "lost"),
        "dirty": (lambda: (W.dirty_batch(3, WL_LANES, n_writes=8000,
                                         n_reads=512, n_nodes=16), None),
                  "dirty"),
    }
    rec["w"] = {}
    for fam, (gen, twin) in specs.items():
        r = rec["w"][fam] = {}
        t0 = time.perf_counter()
        valid_hs, model = gen()
        t_gen = time.perf_counter() - t0
        for viol in (None, twin):
            t0 = time.perf_counter()
            hs = valid_hs if viol is None else _plant(fam, valid_hs)
            t_gen += time.perf_counter() - t0
            d0 = WB.DISPATCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = W.check_wl_batch(hs, fam, model, device=dev)
            wall = time.perf_counter() - t0
            calls = WB.DISPATCHES - d0
            t0 = time.perf_counter()
            host = WB._host_fallback(hs, fam, model)
            t_host = time.perf_counter() - t0
            agree = [WB.agrees_with_oracle(fam, d, o, h)
                     for d, o, h in zip(got, host, hs)]
            n_valid = sum(1 for d in got if d["valid?"] is True)
            key = viol or "valid"
            r[key] = {"lanes": len(hs), "calls": calls, "wall_s": wall,
                      "generate_s": t_gen, "host_s": t_host,
                      "valid_lanes": n_valid, "agree": all(agree),
                      "lanes_per_s": len(hs) / wall}
            print(f"  w {fam} {key}: {len(hs)} lanes, {calls} call, "
                  f"{n_valid} valid; every lane "
                  f"{'agrees' if all(agree) else 'does NOT agree'} with the "
                  f"host oracle; wall {wall:.2f} s "
                  f"({len(hs) / wall:.0f} lanes/s end to end), host oracle "
                  f"{t_host:.2f} s, generation {t_gen:.1f} s")
            _expect(all(agree) and calls == 1,
                    f"(w) {fam} {key}: lanes "
                    f"{[i for i, a in enumerate(agree) if not a][:8]} "
                    f"disagree with the host oracle, {calls} calls")
            _expect(n_valid == (len(hs) if viol is None else 0),
                    f"(w) {fam} {key}: {n_valid} valid lanes")
            if viol is None:
                dims = W.wl_dims(hs, fam, model)
                if fam == "bank":
                    cols = W.encode_bank(hs, model, **dims)
                    prog = lambda *a: W.wl_bank_check(  # noqa: E731
                        *a, n_reads=dims["r_pad"],
                        n_accounts=dims["a_pad"], n_snaps=dims["t_pad"])
                elif fam == "sets":
                    cols = W.encode_sets(hs, **dims)
                    prog = lambda *a: W.wl_sets_check(  # noqa: E731
                        *a, n_elems=dims["e_pad"])
                else:
                    cols = W.encode_dirty(hs, **dims)
                    prog = lambda *a: W.wl_dirty_check(  # noqa: E731
                        *a, n_reads=dims["r_pad"], n_nodes=dims["n_pad"],
                        n_values=dims["v_pad"])
                planes = convert.wl_columns(cols, dev)
                outs = prog(*planes)
                ms = _time_cuda(lambda: prog(*planes), 5)
                nbytes = _nbytes(planes) + _nbytes(outs)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                kernels = _count_kernels(lambda: prog(*planes))
                r["program"] = {"name": f"wl_{fam}_check", "dims": dims,
                                "ms": ms, "bound_ms": bound,
                                "bound_by": "bytes", "bytes": nbytes,
                                "lanes_per_s": len(hs) / (ms / 1e3),
                                "cuda_kernels": kernels,
                                "calls_per_request": 1}
                print(f"  w {fam} program wl_{fam}_check at {dims}: "
                      f"{ms:.3f} ms on the card (CUDA events, warm, mean of "
                      f"5), {len(hs) / (ms / 1e3):.0f} lanes/s; bound "
                      f"{bound:.4f} ms (bytes: {nbytes} read once and "
                      f"written once); {kernels} CUDA kernels per call")


def _i_histories():
    """(i)'s keys: ``(per, keyed)``, each key's 5-process register
    history of KEY_EVENTS events (every 32nd mutated) and the keyed
    history, round-robin over the keys; key k's subhistory is per[k]."""
    from comdb2_tpu_torch.ops import op as O
    from comdb2_tpu_torch.ops.kv import tuple_
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    per = []
    for k in range(KEYS):
        rng = random.Random(30_000 + k)
        h = register_history(rng, n_procs=5, n_events=KEY_EVENTS,
                             values=5, p_info=0.0)
        if k % 32 == 7:
            h = mutate(rng, h, values=5)
        per.append([O.Op(op.process + 5 * k, op.type, op.f, op.value)
                    for op in h])
    keyed = [op.with_(value=tuple_(k, op.value))
             for i in range(max(map(len, per)))
             for k, h in enumerate(per) if i < len(h) for op in (h[i],)]
    return per, keyed


def _independent_request(dev, rec):
    """(i): ``IndependentChecker(Linearizable())`` over 256 keys, each a
    5-process register history of 2000 events, every 32nd mutated: one
    ``check_batch`` launch of the stream kernel, each key's verdict equal
    to its own ``analysis`` on the card."""
    import torch

    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.checker.checkers import Linearizable
    from comdb2_tpu_torch.checker.independent import IndependentChecker
    from comdb2_tpu_torch.models.model import cas_register

    t0 = time.perf_counter()
    per, keyed = _i_histories()
    t_gen = time.perf_counter() - t0
    s0 = SK.STREAM_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = IndependentChecker(Linearizable(device=dev)).check(
        {}, cas_register(), keyed)
    wall = time.perf_counter() - t0
    stream = SK.STREAM_LAUNCHES - s0
    l0 = SK.LAUNCHES
    mismatched = []
    for k in range(KEYS):
        a = analysis(cas_register(), per[k], device=dev)
        res = r["results"][k]
        if (res["valid?"], res.get("op-index")) != \
                (a.valid, a.to_map().get("op-index")):
            mismatched.append(k)
    batch_keys = sum(1 for v in r["results"].values()
                     if v.get("backend") == "device-batch")
    rec["i"] = {"keys": KEYS, "events_per_key": KEY_EVENTS,
                "generate_s": t_gen, "wall_s": wall, "stream_launches": stream,
                "comparison_launches": SK.LAUNCHES - l0,
                "valid": r["valid?"], "failures": r["failures"],
                "device_batch_keys": batch_keys, "mismatched": mismatched}
    print(f"  i: {KEYS} keys x {KEY_EVENTS} events, valid={r['valid?']!r}, "
          f"failures {r['failures']}; {batch_keys} keys VALID from the "
          f"batch launch, the rest re-checked alone; {stream} "
          f"seg_search[stream] launch; wall {wall:.2f} s; "
          f"{'every key equals' if not mismatched else 'keys ' + str(mismatched) + ' differ from'} "
          f"its own analysis")
    _expect(stream == 1 and not mismatched and r["failures"]
            and KEYS // 2 < batch_keys <= KEYS - len(r["failures"]),
            f"(i) IndependentChecker: {rec['i']}")


def _filetest_requests(rec, extra_args=()):
    """(e2): ``filetest --checker ...`` on the txn and wl fixtures, and
    ``--checker wgl`` / ``--checker set`` on a register / set history
    (a set checker needs adds and a final read); exit codes 0 valid, 1
    invalid, as the verify skill records. The device is filetest's
    default (``extra_args`` adds to every command line)."""
    import contextlib
    import io

    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.checker import linear_host
    from comdb2_tpu_torch.checker.checkers import set_checker
    from comdb2_tpu_torch.checker.wl import sets_batch
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    fix = os.path.join(HERE, "tests", "fixtures")
    bank = ["--wl-n", "8", "--wl-total", "160"]
    cases = [([f"{fix}/txn/clean.edn", "--txn"], 0),
             ([f"{fix}/txn/g1c.edn", "--txn"], 1),
             ([f"{fix}/txn/g2_item.edn", "--txn"], 1),
             ([f"{fix}/txn/g2_item.edn", "--txn", "--backend", "device",
               "--realtime"], 1),
             ([f"{fix}/wl/bank_valid.edn", "--checker", "bank"] + bank, 0),
             ([f"{fix}/wl/bank_wrong_total.edn", "--checker", "bank"] + bank,
              1),
             ([f"{fix}/wl/sets_valid.edn", "--checker", "sets"], 0),
             ([f"{fix}/wl/sets_lost.edn", "--checker", "sets"], 1),
             ([f"{fix}/wl/dirty_valid.edn", "--checker", "dirty"], 0),
             ([f"{fix}/wl/dirty_dirty.edn", "--checker", "dirty"], 1)]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_e2_")

    def host_valid(h):
        packed = pack_history(h)
        return linear_host.check(memo(cas_register(), packed), packed).valid

    # a register history and the first mutation of it that is INVALID
    h = register_history(random.Random(12), n_procs=5, n_events=300,
                         values=5, p_info=0.0)
    bad = next(m for m in (mutate(random.Random(s), h, values=5)
                           for s in range(64)) if host_valid(m) is False)
    for name, hh in (("register", h), ("register_mutated", bad)):
        p = os.path.join(tmp.name, f"{name}.edn")
        with open(p, "w") as fh:
            fh.write(history_to_edn(hh))
        cases.append(([p, "--checker", "wgl"], 0 if host_valid(hh) else 1))
    for viol in (None, "lost"):
        h = sets_batch(5, 1, n_adds=200, violation=viol)[0]
        want = set_checker.check({}, None, h)["valid?"]
        p = os.path.join(tmp.name, f"set_{viol}.edn")
        with open(p, "w") as fh:
            fh.write(history_to_edn(h))
        cases.append(([p, "--checker", "set"], 0 if want else 1))
    out = []
    for argv, want in cases:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = filetest.main(argv + list(extra_args))
        name = " ".join(os.path.basename(a) if a.endswith(".edn") else a
                        for a in argv)
        out.append({"argv": name, "exit": rc, "want": want})
    tmp.cleanup()
    rec["e2"] = out
    print("  e2 filetest: " + "; ".join(f"{c['argv']} -> {c['exit']}"
                                        for c in out))
    bad = [c for c in out if c["exit"] != c["want"]]
    _expect(not bad, f"(e2) filetest exit codes differ: {bad}")


def _checker_layer(dev, filetest_args=()):
    """Path 3, the checker layer, requests (t), (t2), (w), (i), (e2).
    Returns its record; raises ``_Failed``."""
    rec = {}
    for step in (_closure_requests, _check_txn_requests, _wl_requests,
                 _independent_request):
        t0 = time.perf_counter()
        step(dev, rec)
        print(f"  ({step.__name__[1:]} took {time.perf_counter() - t0:.1f} s)")
    _filetest_requests(rec, filetest_args)
    return rec


def _start_native_build():
    """Start building ``native/build/libct_sut.so`` (the C++ EDN loader
    behind ``ops.native_loader``) when it is missing and ``cmake`` is
    on the PATH; returns the process or None. Its log goes to
    ``native/build/build.log``."""
    import shutil

    build_dir = os.path.join(HERE, "native", "build")
    if (os.path.exists(os.path.join(build_dir, "libct_sut.so"))
            or not os.path.isdir(os.path.join(HERE, "native"))
            or shutil.which("cmake") is None):
        return None
    os.makedirs(build_dir, exist_ok=True)
    log = open(os.path.join(build_dir, "build.log"), "w")
    cmd = ("cmake -S native -B native/build -DCMAKE_BUILD_TYPE=Release && "
           "cmake --build native/build --target ct_sut -j 8")
    proc = subprocess.Popen(["bash", "-c", cmd], cwd=HERE, stdout=log,
                            stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def _finish_native_build(proc) -> str:
    """Wait for :func:`_start_native_build`'s process; returns what
    happened, for the output."""
    if proc is None:
        return "not started (built already, or no cmake)"
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    proc.log.close()
    return f"cmake exit {rc}"


def _trace_stages(path):
    """Summed milliseconds per span name of a ``--trace`` file, and the
    parse span's ``parser``."""
    with open(path) as fh:
        doc = json.load(fh)
    stages = {}
    parser = None
    for ev in doc["traceEvents"]:
        stages[ev["name"]] = stages.get(ev["name"], 0.0) + ev["dur"] / 1e3
        if ev["name"] == "filetest.parse":
            parser = ev["args"].get("parser")
    return stages, parser, doc["otherData"]["dropped_spans"]


def _j_histories():
    """(j): ``J_LANES`` eight-process register histories of
    ``J_EVENTS`` events over 8 values (the union table has about 77
    transitions, so at P = 8 neither the 62-bit key layout nor the flat
    budget fits, and MXU serves P >= 16 only: vmap is the escalation
    engine); lanes 0 to ``J_OVERFLOW - 1`` keep up to 8 calls in flight
    and overflow the kernel's 128 configs, the rest at most 4. Each
    overflowing lane has one ok value corrupted in its last tenth,
    after the kernel's overflow, so the escalated lanes mix VALID and
    INVALID ones (lanes 0, 1, 3 and 6 are INVALID)."""
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    hs = []
    for i in range(J_LANES):
        h = register_history(random.Random(6000 + i), n_procs=8,
                             n_events=J_EVENTS, values=8, p_info=0.0,
                             max_pending=8 if i < J_OVERFLOW else 4)
        if i < J_OVERFLOW:
            k = len(h) * 9 // 10
            h = h[:k] + mutate(random.Random(7000 + i), h[k:], values=8)
        hs.append(h)
    return hs


def _engine_run(fn, dev):
    """One engine call: its result, wall seconds (host clock ending in
    a synchronise) and card span in ms (CUDA events around the call,
    idle gaps between the host's launches included)."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, e0.elapsed_time(e1)


def _busy_profile(fn):
    """CUDA kernels, their summed ms and the card span of one call of
    ``fn`` under ``torch.profiler`` (None when the profiler sees no
    device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as e:               # measurement only, never a gate
        print(f"  (torch.profiler: {type(e).__name__}: {e})")
        return None
    if not ev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / 1e3
    return {"kernels": len(ev), "busy_ms": busy, "span_ms": span}


def _lane_row_bytes(P: int) -> int:
    """Bytes of one frontier row of the flat and vmap engines: state
    int32, P slots int32, valid bool."""
    return 4 + 4 * P + 1


def _engine_numbers(name, stats, card_ms, wall_s, prof, P, iters_prof):
    """The PERF numbers of one flat / vmap run: the bytes bound counts
    each closure iteration reading its frontier rows once and writing
    them once (``stats["rows"]``) at the HBM rate."""
    bound = 2 * stats["rows"] * _lane_row_bytes(P) / HBM_BYTES_PER_S * 1e3
    rec = {"label": name, "card_ms": card_ms, "wall_s": wall_s,
           "closure_iterations": stats["closure_iterations"],
           "frontier_rows": stats["rows"],
           "host_syncs": stats["host_syncs"], "bound_ms": bound,
           "bound_by": "bytes"}
    if prof is not None and iters_prof:
        rec["profiled_prefix"] = dict(prof, closure_iterations=iters_prof)
        rec["kernels_per_iteration"] = prof["kernels"] / iters_prof
        rec["busy_share_of_prefix"] = prof["busy_ms"] / max(
            prof["span_ms"], 1e-9)
    print(f"  {name}: card {card_ms:.2f} ms (CUDA events), wall "
          f"{wall_s:.3f} s, {stats['closure_iterations']} closure "
          f"iterations over {stats['rows']} frontier rows, "
          f"{stats['host_syncs']} host syncs, bound {bound:.4f} ms "
          f"(bytes)"
          + (f"; profiled prefix: {prof['kernels']} CUDA kernels in "
             f"{iters_prof} iterations = "
             f"{rec['kernels_per_iteration']:.1f} per iteration, card "
             f"busy {prof['busy_ms']:.2f} of {prof['span_ms']:.2f} ms"
             if "kernels_per_iteration" in rec else ""))
    return rec


def _escalation_requests(dev, rec):
    """Path 4, the last batch engines: (j) the stream kernel, its
    overflow escalated through the vmap engine; (j2) (h)'s five-process
    lanes through flat, vmap and keys. Fills ``rec``; returns the
    comparisons to make after the path's counts are read. Raises
    ``_Failed``."""
    import numpy as np

    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.model import cas_register

    t0 = time.perf_counter()
    hs_j = _j_histories()
    batch_j = TB.pack_batch(hs_j, cas_register())
    t_pack = time.perf_counter() - t0
    m = batch_j.memo
    info: dict = {}
    (st, fa, n), wall, card = _engine_run(
        lambda: TB.check_batch(batch_j, F=J_F, info=info, device=dev), dev)
    esc = info.get("escalated") or {}
    rec["j"] = {"lanes": J_LANES, "events": J_EVENTS, "F": J_F,
                "table": [m.n_states, m.n_transitions], "P": batch_j.P,
                "pack_s": t_pack, "wall_s": wall, "card_span_ms": card,
                "engine": info.get("engine"), "escalated": esc,
                "escalation_s": info.get("escalation_s"),
                "stream": info.get("stream"),
                "status_counts": {int(k): int(v) for k, v in zip(
                    *np.unique(st, return_counts=True))}}
    print(f"request j: {J_LANES} x {J_EVENTS} events, table "
          f"{m.n_states}x{m.n_transitions}, F={J_F}: engine "
          f"{info.get('engine')}, escalated {esc.get('count')} lanes "
          f"through {esc.get('engine')} in {info.get('escalation_s', 0):.3f}"
          f" s ({(esc.get('engine_stats') or {}).get('host_syncs')} host "
          f"syncs); request wall {wall:.3f} s (pack {t_pack:.2f} s), card "
          f"span {card:.1f} ms; statuses {rec['j']['status_counts']}")
    _expect(info.get("engine") == "stream" and esc.get("engine") == "vmap"
            and esc.get("count", 0) >= J_OVERFLOW,
            f"(j) did not run the stream kernel and escalate at least "
            f"{J_OVERFLOW} lanes through vmap: {rec['j']}")

    # (j2): (h)'s five-process lanes through flat, vmap and keys
    hs_h5 = [h for h in _h_histories()
             if len({op.process for op in h}) == 5]
    batch_h5 = TB.pack_batch(hs_h5, cas_register())
    out = {}
    for engine in ("keys", "flat", "vmap"):
        inf: dict = {}
        res, wall, card = _engine_run(
            lambda: TB.check_batch(batch_h5, F=J_F, engine=engine,
                                   info=inf, device=dev), dev)
        out[engine] = (res, wall, card, inf)
        print(f"request j2 {engine}: {len(hs_h5)} lanes F={J_F}: wall "
              f"{wall:.3f} s, card span {card:.1f} ms, engine "
              f"{inf.get('engine')}, stats {inf.get('engine_stats')}")
    rec["j2"] = {"lanes": len(hs_h5), "F": J_F,
                 "runs": {k: {"wall_s": v[1], "card_span_ms": v[2],
                              "engine": v[3].get("engine"),
                              "engine_stats": v[3].get("engine_stats")}
                          for k, v in out.items()}}
    keys = out["keys"][0]
    valid = keys[0] == 0
    for engine in ("flat", "vmap"):
        got = out[engine][0]
        _expect(out[engine][3].get("engine") == engine
                and got[0].tolist() == keys[0].tolist()
                and got[1].tolist() == keys[1].tolist()
                and got[2][valid].tolist() == keys[2][valid].tolist(),
                f"(j2) {engine} differs from keys: status "
                f"{got[0].tolist()} fail {got[1].tolist()} against "
                f"{keys[0].tolist()} {keys[1].tolist()}")
    rec["j2"]["statuses"] = {int(k): int(v) for k, v in zip(
        *np.unique(keys[0], return_counts=True))}
    _expect(set(range(J_OVERFLOW)) <= set(info["escalation_lanes"]),
            f"(j) lanes 0-{J_OVERFLOW - 1} did not all escalate: "
            f"{info['escalation_lanes']}")
    esc_st = {int(st[i]) for i in info["escalation_lanes"]}
    rec["j"]["escalated_statuses"] = sorted(
        (int(i), int(st[i]), int(fa[i])) for i in info["escalation_lanes"])
    _expect({LT.VALID, LT.INVALID} <= esc_st,
            f"(j) the escalated lanes do not mix VALID and INVALID: "
            f"{esc_st}")
    return hs_j, batch_j, info, (st, fa, n), info["escalation_lanes"], \
        batch_h5, out


def _escalation_comparisons(dev, rec, hs_j, batch_j, info_j, res_j,
                            esc_lanes, batch_h5, out_j2):
    """After path 4's counts: every (j) lane against its own
    single-history ``analysis`` on the card, the escalated lanes also
    against the host search; then each engine re-run for its numbers
    (card span, host syncs, kernels per closure iteration from a
    profiled prefix, bytes bound)."""
    import numpy as np

    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import linear_host
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.utils import next_pow2

    st, fa, _ = res_j
    t0 = time.perf_counter()
    lanes, mismatched = _lanes_vs_analysis(hs_j, st, fa)
    t_an = time.perf_counter() - t0
    host_bad = []
    for i in esc_lanes:
        p = pack_history(hs_j[i])
        r = linear_host.check(memo(cas_register(), p), p)
        want = (LT.VALID if r.valid else LT.INVALID,
                -1 if r.valid else r.op_index)
        if (int(st[i]), int(fa[i])) != want:
            host_bad.append((i, want))
    rec["j"].update(lanes_mismatched=mismatched, analysis_s=t_an,
                    host_mismatched=host_bad)
    print(f"  j: {J_LANES} lanes against their own analysis in "
          f"{t_an:.1f} s: {len(mismatched)} differ; the "
          f"{len(esc_lanes)} escalated lanes against linear_host: "
          f"{len(host_bad)} differ")
    _expect(not mismatched, f"(j) lanes {mismatched[:10]} differ from "
            f"their single-history analysis: "
            f"{[lanes[i] for i in mismatched[:10]]}")
    _expect(not host_bad, f"(j) lanes differ from linear_host: {host_bad}")

    # the escalation again, alone: the vmap engine on the overflowed
    # lanes, as check_batch ran it (same memo, table and slot width)
    m = batch_j.memo
    succ = LT.pad_succ(m.succ, next_pow2(m.n_states),
                       next_pow2(m.n_transitions))
    P = next_pow2(batch_j.P, 2)
    idx = list(esc_lanes)
    stats: dict = {}
    args = (succ, batch_j.kind[idx], batch_j.proc[idx], batch_j.tr[idx])
    kw = dict(F=J_F, P=P, n_states=m.n_states,
              n_transitions=m.n_transitions, device=dev)
    r, wall, card = _engine_run(
        lambda: LT.check_device_batch(*args, stats=stats, **kw), dev)
    _expect(r[0].tolist() == [int(st[i]) for i in idx]
            and r[1].tolist() == [int(fa[i]) for i in idx],
            "(j) the vmap engine alone differs from its escalation")
    pre_stats: dict = {}
    n_pre = 64
    prof = _busy_profile(lambda: LT.check_device_batch(
        succ, batch_j.kind[idx, :n_pre], batch_j.proc[idx, :n_pre],
        batch_j.tr[idx, :n_pre], stats=pre_stats, **kw))
    rec["j"]["vmap"] = _engine_numbers(
        f"j vmap ({len(idx)} escalated lanes)", stats, card, wall, prof, P,
        pre_stats.get("closure_iterations"))

    # (j2): flat and vmap numbers at (h)'s five-process lanes
    m5 = batch_h5.memo
    succ5 = LT.pad_succ(m5.succ, next_pow2(m5.n_states),
                        next_pow2(m5.n_transitions))
    P5 = next_pow2(batch_h5.P, 2)
    kw5 = dict(F=J_F, P=P5, n_states=m5.n_states,
               n_transitions=m5.n_transitions, device=dev)
    sb = TB.segment_batch(batch_h5)
    B5 = len(batch_h5)
    for engine in ("flat", "vmap"):
        stats = out_j2[engine][3]["engine_stats"]
        pre_stats = {}
        if engine == "flat":
            n_pre = 16
            prof = _busy_profile(lambda: LT.check_device_flat(
                succ5, sb.inv_proc[:n_pre], sb.inv_tr[:n_pre],
                sb.ok_proc[:n_pre], sb.depth[:n_pre], B=B5,
                stats=pre_stats, **kw5))
        else:
            n_pre = 64
            prof = _busy_profile(lambda: LT.check_device_batch(
                succ5, batch_h5.kind[:, :n_pre], batch_h5.proc[:, :n_pre],
                batch_h5.tr[:, :n_pre], stats=pre_stats, **kw5))
        rec["j2"]["runs"][engine].update(_engine_numbers(
            f"j2 {engine}", stats, out_j2[engine][2], out_j2[engine][1],
            prof, P5, pre_stats.get("closure_iterations")))


def make_ring(k: int, dirty: bool, dp: int = 500, dk: int = 500):
    """A write-skew rw ring of ``k`` sequential txns (t_i reads key_i
    empty, appends to key_{i+1}) and an audit read of every key, on
    processes and keys from ``dp`` / ``dk`` (copied from
    ``scripts/bench_shrink.py``). With ``dirty``, one ring txn FAILS but
    its append is observed by the audit read: the ``-R`` dirty-commit
    signature (G1a and a cycle through the dirty txn); without, the
    ``-T`` write-skew signature."""
    from comdb2_tpu_torch.ops import op as O

    h = []
    for i in range(k):
        mops = (("r", dk + i, None), ("append", dk + (i + 1) % k, 1))
        done = (("r", dk + i, ()), ("append", dk + (i + 1) % k, 1))
        typ = "fail" if dirty and i == 0 else "ok"
        h.append(O.invoke(dp + i, "txn", mops))
        h.append(O.Op(dp + i, typ, "txn", done))
    audit = tuple(("r", dk + i, (1,)) for i in range(k))
    h.append(O.invoke(dp + k, "txn",
                      tuple(("r", dk + i, None) for i in range(k))))
    h.append(O.Op(dp + k, "ok", "txn", audit))
    return h


def register_seed(n_events: int, kind: str):
    """``scripts/bench_shrink.py``'s register seed: a 3-process register
    history, write-only (read-only for lost-update), with one known
    minimal anomaly planted at its end. Returns ``(history, truth)``."""
    from comdb2_tpu_torch.ops.synth import inject_anomaly, register_history

    fs = ("read",) if kind == "lost-update" else ("write",)
    base = register_history(random.Random(7), n_procs=3, n_events=n_events,
                            fs=fs, p_info=0.0, max_pending=2)
    return inject_anomaly(base, kind)


def _sig(op):
    return (op.process, op.type, op.f, op.value)


class _CardTimer:
    """CUDA events around every call of ``mod.name`` (a function that
    queues work on the card) while the context is open; ``calls`` holds
    ``(host start, start event, end event)``."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.calls = []

    def __enter__(self):
        import torch

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t = time.monotonic()
            e0.record()
            out = self.real(*a, **kw)
            e1.record()
            self.calls.append((t, e0, e1))
            return out

        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)
        return False

    def ms(self):
        """``[(host start, card ms)]`` per call."""
        import torch

        torch.cuda.synchronize()
        return [(t, e0.elapsed_time(e1)) for t, e0, e1 in self.calls]


def _rounds_split(spans, card):
    """Per ``shrink.step`` span (one round), its phase, wall and the
    seconds of its child spans by stage, plus the card milliseconds of
    the timed calls that started inside it (``card``: ``[(host start,
    ms)]``, on the trace's monotonic clock)."""
    steps = [s for s in spans if s.name == "shrink.step"]
    stage = {"shrink.pack": "pack", "batch.remap": "segments",
             "batch.dispatch": "dispatch", "batch.finalize": "finalize"}
    out = []
    for st in steps:
        row = {"phase": st.args.get("phase"), "wall_ms":
               (st.t1 - st.t0) * 1e3, "card_ms": sum(
                   ms for t, ms in card if st.t0 <= t <= st.t1)}
        for k in stage.values():
            row[k + "_ms"] = 0.0
        out.append((st, row))
    for s in spans:
        if s.name not in stage:
            continue
        p = s.parent
        while p is not None and p.name != "shrink.step":
            p = p.parent
        for st, row in out:
            if st is p:
                row[stage[s.name] + "_ms"] += (s.t1 - s.t0) * 1e3
    return [row for _, row in out]


def _certified(ops) -> bool:
    """The 1-minimality certificate re-derived on the host: ``ops`` is
    INVALID under ``linear_host`` and removing any single atom leaves it
    not INVALID."""
    from comdb2_tpu_torch.checker import linear_host
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.columnar import subset_packed
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.shrink import atoms_of

    def host_valid(h):
        p = pack_history(list(h))
        return linear_host.check(memo(cas_register(), p), p).valid

    p = pack_history([op.with_() for op in ops])
    atoms, pinned = atoms_of(p)
    if host_valid(p.ops) is not False or not atoms:
        return False
    for k in range(len(atoms)):
        keep = pinned.copy()
        for j, a in enumerate(atoms):
            if j != k:
                keep[a] = True
        if host_valid(subset_packed(p, keep).ops) is False:
            return False
    return True


def _traced_run(fn, timers):
    """Run ``fn`` with the port's trace on and ``timers`` open; returns
    ``(result, wall s, spans, [(host start, card ms)])``."""
    import contextlib

    import torch

    from comdb2_tpu_torch.obs import trace as obs_trace

    obs_trace.clear()
    obs_trace.enable()
    try:
        with contextlib.ExitStack() as stack:
            for t in timers:
                stack.enter_context(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = obs_trace.spans()
    finally:
        obs_trace.disable()
        obs_trace.clear()
    return out, wall, spans, [c for t in timers for c in t.ms()]


def _shrink_linear(dev, rec, label, n_events):
    """(s10) / (s): ``minimize(checker="linear", F=SHRINK_F,
    engine="auto")`` on the card on ``register_seed``'s stale-read and
    lost-update shapes: the injected truth recovered, ``one_minimal``,
    the certificate re-derived on the host, ``render_minimal`` INVALID,
    and rounds / candidates / dispatches equal to ``RECORDED_SHRINK``.
    Prints the wall, the stream launches, their card
    time and the host split per round."""
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.report.shrink_svg import render_minimal
    from comdb2_tpu_torch.shrink import minimize

    rec[label] = {}
    for kind in ("stale-read", "lost-update"):
        t0 = time.perf_counter()
        h, truth = register_seed(n_events, kind)
        t_gen = time.perf_counter() - t0
        s0 = SK.STREAM_LAUNCHES
        r, wall, spans, card = _traced_run(
            lambda: minimize(h, checker="linear", model="cas-register",
                             F=SHRINK_F, engine="auto", device=dev),
            [_CardTimer(SK, "seg_search_stream")])
        launches = SK.STREAM_LAUNCHES - s0
        rounds = _rounds_split(spans, card)
        t0 = time.perf_counter()
        cert = _certified(r.ops)
        rv, svg = render_minimal(r.ops)
        t_check = time.perf_counter() - t0
        got = (r.rounds, r.candidates, r.dispatches)
        want = RECORDED_SHRINK[(label, kind)]
        row = {"seed_ops": r.seed_ops, "n_ops": r.n_ops, "rounds": r.rounds,
               "candidates": r.candidates, "dispatches": r.dispatches,
               "one_minimal": r.one_minimal, "stream_launches": launches,
               "card_ms": sum(ms for _, ms in card), "wall_s": wall,
               "generate_s": t_gen, "certified_on_host": cert,
               "render_minimal_valid": rv, "recorded": want,
               "host_check_s": t_check, "per_round": rounds}
        rec[label][kind] = row
        tot = {k: sum(x[k] for x in rounds) for k in
               ("pack_ms", "segments_ms", "dispatch_ms", "finalize_ms")}
        print(f"  {label} {kind}: {r.seed_ops} -> {r.n_ops} ops, wall "
              f"{wall:.3f} s, {r.rounds} rounds, {r.candidates} candidates, "
              f"{r.dispatches} dispatches, {launches} seg_search[stream] "
              f"launches, card {row['card_ms']:.3f} ms (CUDA events); host "
              f"split over the rounds: subset_packed + pack_batch_masked "
              f"{tot['pack_ms']:.1f} ms, segments {tot['segments_ms']:.1f}, "
              f"dispatch {tot['dispatch_ms']:.1f} (the kernel "
              f"{row['card_ms']:.1f} of it), finalize "
              f"{tot['finalize_ms']:.1f}; one_minimal {r.one_minimal}, "
              f"certificate on the host {cert}, render_minimal {rv!r}; "
              f"recorded {want}")
        print(f"    per round (ms: wall / pack / segments / dispatch / "
              f"kernel / finalize): " + "; ".join(
                  f"{x['phase']} {x['wall_ms']:.1f}/{x['pack_ms']:.1f}/"
                  f"{x['segments_ms']:.1f}/{x['dispatch_ms']:.1f}/"
                  f"{x['card_ms']:.2f}/{x['finalize_ms']:.1f}"
                  for x in rounds))
        _expect(sorted(map(_sig, r.ops)) == sorted(map(_sig, truth)),
                f"({label}) {kind}: the minimal ops are not the injected "
                f"truth: {[_sig(o) for o in r.ops]}")
        _expect(r.one_minimal and not r.partial and cert and rv is False
                and svg is not None and launches > 0,
                f"({label}) {kind}: not certified 1-minimal, or no stream "
                f"launch: {row}")
        _expect(got == want,
                f"({label}) {kind}: rounds, candidates, dispatches {got} "
                f"differ from the recorded {want}")


def _shrink_round_batch(dev):
    """(s10) stale-read's first ddmin round: its two candidates (the
    halves of every atom) packed as the round packs them, for the
    kernel-vs-plain comparison."""
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.shrink import Shrinker
    from comdb2_tpu_torch.shrink.core import _chunks

    h, _ = register_seed(S10_EVENTS, "stale-read")
    job = Shrinker(h, "cas-register", F=SHRINK_F, device=dev)
    masks = [job.mask_of(c) for c in _chunks(job.cur, 2)]
    return TB.pack_batch_masked(job.packed, masks, job.memo)


def _shrink_txn(dev, rec, base):
    """(st): ``minimize(checker="txn")`` on the card on (t2)'s 2400-txn
    base with ``make_ring(8)`` (``-T``) and ``make_ring(8, dirty=True)``
    (``-R``) appended: the seed closure at the 4096 bucket, then the
    rounds through ``closure_diag_batch``; every field equal to
    ``RECORDED_TXN`` and the ops to the ring's; ``render_minimal``
    INVALID on the host. Prints the closure's card time per round."""
    from comdb2_tpu_torch.report.shrink_svg import render_minimal
    from comdb2_tpu_torch.shrink import minimize
    from comdb2_tpu_torch.txn import closure_torch as TCL

    rec["st"] = {}
    for name, dirty in (("-T", False), ("-R", True)):
        ring = make_ring(8, dirty=dirty)
        h = base + ring
        d0 = TCL.DISPATCHES
        r, wall, spans, card = _traced_run(
            lambda: minimize(h, checker="txn", device=dev),
            [_CardTimer(TCL, "_diag_kernel")])
        rounds = _rounds_split(spans, card)
        rv, svg = render_minimal(r.ops, checker="txn")
        got = {k: r.extra.get(k) for k in ("txns", "evidence_txns",
                                           "anomaly_class", "seed_class")}
        got.update(rounds=r.rounds, candidates=r.candidates,
                   dispatches=r.dispatches)
        rec["st"][name] = {**got, "n_ops": r.n_ops, "seed_ops": r.seed_ops,
                           "one_minimal": r.one_minimal, "wall_s": wall,
                           "closure_calls": TCL.DISPATCHES - d0,
                           "render_minimal_valid": rv,
                           "per_round": rounds}
        print(f"  st {name}: {r.seed_ops} -> {r.n_ops} ops, txns "
              f"{got['txns']}, evidence {got['evidence_txns']}, class "
              f"{got['anomaly_class']} (seed {got['seed_class']}); "
              f"{r.rounds} rounds, {r.candidates} candidates, "
              f"{r.dispatches} closure calls; wall {wall:.3f} s; "
              f"render_minimal {rv!r}; closure card ms per round: "
              + ", ".join(f"{x['phase']} {x['card_ms']:.3f}"
                          for x in rounds))
        _expect(got == RECORDED_TXN and r.one_minimal
                and [_sig(o) for o in r.ops] == [_sig(o) for o in ring]
                and rv is False and svg is not None,
                f"(st) {name}: {got} / ops {[_sig(o) for o in r.ops]} "
                f"differ from the recorded {RECORDED_TXN} / the ring, or "
                f"render_minimal re-checked {rv!r}")


def _shrink_filetest(rec):
    """(sf): ``filetest --shrink --store`` on the INVALID fixtures (exit
    1; ``minimal.edn``, ``results.edn`` and ``shrink.svg`` in one run
    directory, certified and re-checked INVALID; ``filetest`` on the
    written ``minimal.edn`` exits 1), and on ``clean.edn`` (exit 0, the
    seed-rejection message, no store)."""
    import contextlib
    import io

    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.ops.edn import read_edn

    fix = os.path.join(HERE, "tests", "fixtures")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sf_")
    out = []
    for path, txn in (("shrink/stale_read.edn", []),
                      ("txn/g2_item.edn", ["--txn"]),
                      ("txn/g1c.edn", ["--txn"]),
                      ("txn/clean.edn", ["--txn"])):
        store = os.path.join(tmp.name, os.path.basename(path))
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = filetest.main([os.path.join(fix, path), "--shrink",
                                "--store", store] + txn)
        row = {"file": path, "exit": rc, "wall_s": time.perf_counter() - t0}
        if path.endswith("clean.edn"):
            row["rejected"] = "only INVALID histories shrink" in err.getvalue()
            row["store_made"] = os.path.exists(store)
            ok = rc == 0 and row["rejected"] and not row["store_made"]
        else:
            root = os.path.join(store, "shrink")
            runs = [d for d in os.listdir(root) if d != "latest"]
            run = os.path.join(root, runs[0])
            files = sorted(os.listdir(run))
            res = read_edn(open(os.path.join(run, "results.edn")).read())
            with contextlib.redirect_stdout(io.StringIO()):
                rc2 = filetest.main([os.path.join(run, "minimal.edn")] + txn)
            row.update(runs=len(runs), files=files, minimal_ops=res.get(
                "minimal-ops"), one_minimal=res.get("one-minimal?"),
                reverified=res.get("reverified-valid?"), minimal_exit=rc2)
            ok = (rc == 1 and len(runs) == 1 and files == [
                "minimal.edn", "results.edn", "shrink.svg"]
                and res.get("one-minimal?") is True
                and res.get("reverified-valid?") is False and rc2 == 1)
        row["ok"] = ok
        out.append(row)
    tmp.cleanup()
    rec["sf"] = out
    print("  sf filetest --shrink: " + "; ".join(
        f"{r['file']} -> {r['exit']}" + (
            f" ({r['minimal_ops']} ops, minimal.edn -> {r['minimal_exit']})"
            if "minimal_exit" in r else " (seed rejected)")
        for r in out))
    bad = [r for r in out if not r["ok"]]
    _expect(not bad, f"(sf) filetest --shrink: {bad}")


def _checker_artifacts(dev, rec, h_b, base):
    """(sa): the checker objects' store artifacts on the card's verdicts:
    ``Linearizable`` on (b)'s 100k-event INVALID history writes
    ``linear.svg``; ``Serializable`` on (t2)'s G1c history writes
    ``serializable.txt`` and ``.svg``; ``IndependentChecker`` on (i)'s
    256 keys writes every key's ``independent/<k>/results.edn`` and
    ``history.edn``, and ``linear.svg`` for each INVALID key. Every
    ``results.edn`` (the two single checkers' maps saved through the
    store's ``save_2``) reads back equal to the returned map."""
    from comdb2_tpu_torch.checker.checkers import Linearizable, Serializable
    from comdb2_tpu_torch.checker.independent import IndependentChecker
    from comdb2_tpu_torch.harness import store
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.edn import read_edn
    from comdb2_tpu_torch.ops.synth import txn_anomaly_history

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sa_")

    def saved(name, result):
        test = {"name": name, "start-time": "run", "results": result,
                "store-root": os.path.join(tmp.name, "store")}
        store.save_2(test)
        back = store.load(name, "run", test["store-root"]).get("results")
        return back == store._edn_safe(result)

    out = {}
    d = os.path.join(tmp.name, "linear")
    t0 = time.perf_counter()
    r = Linearizable(device=dev).check({"dir": d}, cas_register(), h_b)
    out["linear"] = {"valid": r["valid?"], "wall_s": time.perf_counter() - t0,
                     "files": sorted(os.listdir(d)),
                     "results_edn": saved("linear", r)}
    d = os.path.join(tmp.name, "serializable")
    t0 = time.perf_counter()
    r = Serializable(device=dev).check(
        {"dir": d}, None, base + _fresh(txn_anomaly_history("g1c"), 10_000))
    out["serializable"] = {"valid": r["valid?"],
                           "wall_s": time.perf_counter() - t0,
                           "files": sorted(os.listdir(d)),
                           "results_edn": saved("serializable", r)}
    _, keyed = _i_histories()
    d = os.path.join(tmp.name, "independent")
    t0 = time.perf_counter()
    r = IndependentChecker(Linearizable(device=dev)).check(
        {"dir": d}, cas_register(), keyed)
    wall = time.perf_counter() - t0
    bad_keys = []
    for k in range(KEYS):
        kd = os.path.join(d, "independent", str(k))
        files = sorted(os.listdir(kd))
        want = ["history.edn", "results.edn"] + (
            ["linear.svg"] if k in r["failures"] else [])
        back = read_edn(open(os.path.join(kd, "results.edn")).read())
        if files != sorted(want) or \
                back != store._edn_safe(r["results"][k]):
            bad_keys.append(k)
    out["independent"] = {"valid": r["valid?"], "failures": r["failures"],
                          "wall_s": wall, "bad_keys": bad_keys}
    tmp.cleanup()
    rec["sa"] = out
    print(f"  sa artifacts: Linearizable on (b) {out['linear']['files']} "
          f"({out['linear']['wall_s']:.2f} s); Serializable on (t2)+G1c "
          f"{out['serializable']['files']} "
          f"({out['serializable']['wall_s']:.2f} s); IndependentChecker on "
          f"(i)'s {KEYS} keys: results.edn + history.edn for every key, "
          f"linear.svg for the INVALID keys {r['failures']} ({wall:.2f} s); "
          f"results.edn read back equal: linear "
          f"{out['linear']['results_edn']}, serializable "
          f"{out['serializable']['results_edn']}, keys differing "
          f"{bad_keys}")
    _expect(out["linear"]["valid"] is False
            and out["linear"]["files"] == ["linear.svg"]
            and out["linear"]["results_edn"]
            and out["serializable"]["valid"] is False
            and out["serializable"]["files"] == ["serializable.svg",
                                                 "serializable.txt"]
            and out["serializable"]["results_edn"]
            and r["failures"] and not bad_keys,
            f"(sa) checker artifacts: {out}")


def _shrink_path(dev, h_b):
    """Path 5, shrink: requests (s10), (s), (st), (sf), (sa). Returns its
    record and (s10)'s first-round batch for the kernel-vs-plain
    comparison; raises ``_Failed``."""
    from comdb2_tpu_torch.ops.synth import list_append_history

    rec = {}
    t0 = time.perf_counter()
    base = list_append_history(random.Random(2048), n_procs=16,
                               n_txns=TXN_COUNT, n_keys=64, max_micro=4)
    rec["txn_base_generate_s"] = time.perf_counter() - t0
    steps = (("s10", lambda: _shrink_linear(dev, rec, "s10", S10_EVENTS)),
             ("s", lambda: _shrink_linear(dev, rec, "s", S_EVENTS)),
             ("st", lambda: _shrink_txn(dev, rec, base)),
             ("sf", lambda: _shrink_filetest(rec)),
             ("sa", lambda: _checker_artifacts(dev, rec, h_b, base)))
    for name, step in steps:
        t0 = time.perf_counter()
        step()
        rec[f"{name}_s"] = time.perf_counter() - t0
        print(f"  ({name} took {rec[f'{name}_s']:.1f} s)")
    return rec, _shrink_round_batch(dev)


# --- path 6: streaming sessions ---------------------------------------------

STREAM_DELTA = 256        # (v1), (v2): events per append (391 appends of (a))
STREAM_D_DELTA = 64       # (v3): events per append of (d)
STREAM_LANES = 16         # (v5): the top of MEGABATCH_LANES
STREAM_BEAT = 128         # (v5): events per beat
STREAM_SIDE = 640         # (v5): events of the forced xla lanes
STREAM_PARITY = 16        # (v9): appends of (v1) held against the plain version


class _TimedLaunches:
    """Times every segment-search launch by CUDA events recorded right
    before and right after the library call (so the wrapper's host
    work stays outside), and keeps copies of the launches' inputs and
    outputs while ``capture`` is set: ``build.load`` hands out a proxy
    of the seg_search library while installed."""

    def __init__(self):
        self.events = []          # (e0, e1) per launch, in order
        self.captured = []        # (args, (ws_out, stat_out)) per launch
        self.capture = False
        self._orig = None

    def install(self):
        from comdb2_tpu_torch.kernels import build
        from comdb2_tpu_torch.stream import engine as TE

        self._orig = (build.load, TE.stream_kernel_chunk)
        load, chunk = self._orig
        outer = self

        class _Lib:
            def __init__(self, lib):
                self._lib = lib

            def __getattr__(self, name):
                return getattr(self._lib, name)

            def seg_search_launch(self, *args):
                import torch

                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                err = self._lib.seg_search_launch(*args)
                e1.record()
                outer.events.append((e0, e1))
                return err

        def timed_load(name="seg_search", defines=()):
            lib = load(name, defines)
            return _Lib(lib) if name == "seg_search" and not defines \
                else lib

        def capturing_chunk(seg, off, stride, ws, stat, table, spec):
            out = chunk(seg, off, stride, ws, stat, table, spec)
            if outer.capture:
                outer.captured.append((
                    (seg.clone(), off, stride, ws.clone(), stat.clone(),
                     table.clone(), spec),
                    (out[0].clone(), out[1].clone())))
            return out

        build.load = timed_load
        TE.stream_kernel_chunk = capturing_chunk

    def uninstall(self):
        from comdb2_tpu_torch.kernels import build
        from comdb2_tpu_torch.stream import engine as TE

        build.load, TE.stream_kernel_chunk = self._orig

    def ms(self, lo: int, hi: int) -> float:
        """Card milliseconds of launches [lo, hi)."""
        return sum(e0.elapsed_time(e1) for e0, e1 in self.events[lo:hi])


class _SyncCount:
    """Counts the kernel rung's device-to-host readbacks: a stat read
    that is not already on the host, and a carry re-encode on growth."""

    def __init__(self):
        self.n = 0
        self._orig = None

    def install(self):
        from comdb2_tpu_torch.stream import engine as TE

        self._orig = (TE.KernelCarry.read, TE.KernelCarry.respec)
        read, respec = self._orig
        outer = self

        def counted_read(eng):
            if eng._read is None:
                outer.n += 1
            return read(eng)

        def counted_respec(eng, *a):
            spec0 = eng.spec
            ok = respec(eng, *a)
            if ok and eng.spec != spec0:
                outer.n += 1
            return ok

        TE.KernelCarry.read = counted_read
        TE.KernelCarry.respec = counted_respec

    def uninstall(self):
        from comdb2_tpu_torch.stream import engine as TE

        TE.KernelCarry.read, TE.KernelCarry.respec = self._orig


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _stream_live(rec, timer, syncs, h_a):
    """(v1): (a)'s 100k events appended live, STREAM_DELTA at a time, to
    one ``StreamSession`` on the card; checkpointed (wire form) at 50%."""
    import torch

    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.stream import checkpoint as CK
    from comdb2_tpu_torch.stream import engine as TE

    s = StreamSession("cas-register")
    cuts = list(range(0, len(h_a), STREAM_DELTA))
    walls, card, n_sync, per_disp = [], [], [], []
    wire = None
    d_all = TE.DISPATCHES
    for j, i in enumerate(cuts):
        timer.capture = j < STREAM_PARITY
        k0, s0, d0 = len(timer.events), syncs.n, TE.DISPATCHES
        t0 = time.perf_counter()
        s.append(h_a[i:i + STREAM_DELTA])
        walls.append(time.perf_counter() - t0)
        card.append((k0, len(timer.events)))
        n_sync.append(syncs.n - s0)
        per_disp.append(TE.DISPATCHES - d0)
        if j == len(cuts) // 2 - 1:
            wire = CK.to_wire(s.checkpoint())
            ck_at = i + STREAM_DELTA
    timer.capture = False
    t0 = time.perf_counter()
    out = s.finalize_input()
    t_fin = time.perf_counter() - t0
    torch.cuda.synchronize()
    card_ms = [timer.ms(lo, hi) for lo, hi in card]
    q = max(len(walls) // 4, 1)
    r = {"appends": len(cuts), "delta_events": STREAM_DELTA,
         "verdict": {k: out.get(k) for k in (
             "valid", "op_index", "final_count", "engine", "segments",
             "dispatches", "replays", "checked_through")},
         "engines_tried": out.get("engines_tried"),
         "wall_ms": {"median": _pct(walls, 0.5) * 1e3,
                     "p99": _pct(walls, 0.99) * 1e3,
                     "first_quarter_mean": sum(walls[:q]) / q * 1e3,
                     "last_quarter_mean": sum(walls[-q:]) / q * 1e3,
                     "total_s": sum(walls), "finalize_ms": t_fin * 1e3},
         "card_ms": {"mean": sum(card_ms) / len(card_ms),
                     "median": _pct(card_ms, 0.5),
                     "first_quarter_mean": sum(card_ms[:q]) / q,
                     "last_quarter_mean": sum(card_ms[-q:]) / q,
                     "total": sum(card_ms)},
         "host_syncs_per_append": sum(n_sync) / len(n_sync),
         "host_syncs_max": max(n_sync),
         "dispatches": TE.DISPATCHES - d_all,
         "dispatches_per_append_max": max(per_disp),
         "carry_bytes": s.carry_nbytes(),
         "checkpoint_wire_bytes": CK.wire_nbytes(wire),
         "checkpoint_at_event": ck_at}
    r["card_idle_share"] = 1 - r["card_ms"]["total"] / (
        r["wall_ms"]["total_s"] * 1e3)
    rec["v1"] = r
    return s, wire, ck_at, out


def _stream_invalid(rec, h_b):
    """(v2): (b)'s INVALID mutation streamed the same way: it latches,
    and later appends dispatch nothing."""
    from comdb2_tpu_torch.stream import StreamSession

    s = StreamSession("cas-register")
    latched_at, after = None, 0
    t0 = time.perf_counter()
    for j, i in enumerate(range(0, len(h_b), STREAM_DELTA)):
        d0 = s.dispatches
        was = s.valid
        out = s.append(h_b[i:i + STREAM_DELTA])
        if was is not True:
            _expect(s.dispatches == d0 and out.get("latched"),
                    f"(v2) append {j} after the latch dispatched")
            after += 1
        elif out["valid"] is not True and latched_at is None:
            latched_at = j
    out = s.finalize_input()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ce = s.counterexample()
    t_ce = time.perf_counter() - t0
    rec["v2"] = {"verdict": {k: out.get(k) for k in (
                     "valid", "op_index", "dispatches", "appends")},
                 "latched_at_append": latched_at,
                 "appends_after_latch": after, "wall_s": wall,
                 "counterexample_s": t_ce}
    return out, ce


def _stream_overflow(rec, h_d):
    """(v3): (d) in STREAM_D_DELTA-event appends: the kernel rung
    overflows at 128, one replay re-routes the session to the xla rung,
    which escalates in place."""
    from comdb2_tpu_torch.stream import StreamSession

    s = StreamSession("cas-register")
    t0 = time.perf_counter()
    for i in range(0, len(h_d), STREAM_D_DELTA):
        s.append(h_d[i:i + STREAM_D_DELTA])
    out = s.finalize_input()
    rec["v3"] = {"verdict": {k: out.get(k) for k in (
                     "valid", "op_index", "engine", "replays",
                     "frontier_capacity", "dispatches", "final_count")},
                 "engines_tried": out.get("engines_tried"),
                 "wall_s": time.perf_counter() - t0}
    return out


def _stream_wide(rec, h_f):
    """(v4): (f)'s P = 17 history through the MXU rung, escalating in
    place up to 131072."""
    from comdb2_tpu_torch.stream import StreamSession

    ops = list(h_f.ops)                 # (f) is a PackedHistory
    s = StreamSession("cas-register")
    t0 = time.perf_counter()
    for i in range(0, len(ops), 8):
        s.append(ops[i:i + 8])
    out = s.finalize_input()
    rec["v4"] = {"verdict": {k: out.get(k) for k in (
                     "valid", "engine", "replays", "frontier_capacity",
                     "final_count", "dispatches")},
                 "events": len(ops), "wall_s": time.perf_counter() - t0}
    return out


def _beats(sessions, histories, step, timer=None, capture_beat=None):
    """Advance ``sessions`` through ``histories`` in ``step``-event beats,
    one MegaBatch per beat; per beat the device calls, and the beat's
    wall. Returns the collectors' lane counts per beat."""
    from comdb2_tpu_torch.stream import engine as TE

    n = max(len(h) for h in histories)
    calls, walls = [], []
    for b, i in enumerate(range(0, n, step)):
        if timer is not None:
            timer.capture = b == capture_beat
        coll = TE.MegaBatch()
        d0 = TE.DISPATCHES
        t0 = time.perf_counter()
        fins = [s.append_stage(h[i:i + step], collector=coll)
                for s, h in zip(sessions, histories)]
        coll.flush()
        for f in fins:
            f()
        walls.append(time.perf_counter() - t0)
        calls.append((TE.DISPATCHES - d0, list(coll.lane_counts),
                      coll.masked_lanes))
    if timer is not None:
        timer.capture = False
    return calls, walls


def _carry_equal(a, b) -> bool:
    import torch

    ea, eb = a.checkpoint()["eng"], b.checkpoint()["eng"]

    def eq(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, (tuple, list)):
            return len(x) == len(y) and all(map(eq, x, y))
        if hasattr(x, "shape"):
            return x.dtype == y.dtype and x.shape == y.shape \
                and bool((x == y).all())
        return x == y

    del torch
    return eq(ea, eb)


def _stream_megabatch(rec, timer):
    """(v5): 16 kernel-rung sessions of (i)'s keys in STREAM_BEAT-event
    beats, one MegaBatch per beat; then 4 xla-rung and 4 mxu-rung lanes,
    forced with ``engine=``; every lane against the same session solo."""
    from comdb2_tpu_torch.ops import op as O
    from comdb2_tpu_torch.ops.synth import (pinned_wide_history,
                                             register_history)
    from comdb2_tpu_torch.stream import StreamSession

    per = []
    for k in range(STREAM_LANES):
        rng = random.Random(30_000 + k)
        per.append(register_history(rng, n_procs=5, n_events=KEY_EVENTS,
                                    values=5, p_info=0.0))
    r = rec["v5"] = {}
    out = {}
    for label, engine, hs, step in (
            ("kernel", "auto", per, STREAM_BEAT),
            ("xla", "xla", [h[:STREAM_SIDE] for h in per[:4]],
             STREAM_BEAT),
            ("mxu", "mxu", None, 4)):
        if label == "mxu":
            # one wide prefix (pinned slots: P = 18), then the same
            # two-beat tail on every lane, as the JAX package's
            # megabatch test does — lanes of one shape class
            wide = pinned_wide_history(18)
            tail = [O.invoke(0, "write", 2), O.ok(0, "write", 2),
                    O.invoke(1, "read", None), O.ok(1, "read", 2)] * 2
            tails = [list(tail) for _ in range(4)]
            hs = tails
        fused = [StreamSession("cas-register", engine=engine) for _ in hs]
        solo = [StreamSession("cas-register", engine=engine) for _ in hs]
        if label == "mxu":
            # the pinned prefix solo, then the beats fuse the tails
            for s in fused + solo:
                s.append(wide)
        calls, walls = _beats(fused, hs, step, timer if label == "kernel"
                              else None, capture_beat=8)
        t0 = time.perf_counter()
        for s, h in zip(solo, hs):
            for i in range(0, len(h), step):
                s.append(h[i:i + step])
        t_solo = time.perf_counter() - t0
        vf = [s.finalize_input() for s in fused]
        vs = [s.finalize_input() for s in solo]
        same = [a == b and _carry_equal(f, s)
                for a, b, f, s in zip(vf, vs, fused, solo)]
        r[label] = {"lanes": len(hs), "beats": len(calls),
                    "calls_per_beat": sorted({c for c, _, _ in calls}),
                    "lanes_per_call": calls[0][1],
                    "masked_lanes": calls[0][2],
                    "beat_wall_ms_median": _pct(walls, 0.5) * 1e3,
                    "fused_wall_s": sum(walls), "solo_wall_s": t_solo,
                    "rungs": sorted({v["engine"] for v in vf}),
                    "verdicts": [v["valid"] for v in vf],
                    "bit_equal_to_solo": all(same)}
        out[label] = (calls, vf, same)
    return out


def _stream_workloads(rec):
    """(v6): a bank session at (w)'s bank size and a sets session with
    8000 elements, each with its planted twin, in deltas; and a 16-lane
    bank megabatch against the same sessions solo."""
    import torch

    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.stream import wl as SW

    bank, model = W.bank_batch(1, 1, n_accounts=8, n_transfers=512,
                               n_reads=512)
    sets = W.sets_batch(2, 1, n_adds=8000)
    runs = {}
    for fam, hs, step, twin in (("bank", bank, 256, "total"),
                                ("sets", sets, 1000, "lost")):
        for key, h in (("valid", hs[0]), (twin, _plant(fam, hs)[0])):
            s = SW.make_session(f"wl-{fam}", model if fam == "bank"
                                else None)
            t0 = time.perf_counter()
            for i in range(0, len(h), step):
                s.append(h[i:i + step])
            out = s.close()
            runs[(fam, key)] = (h, out, model if fam == "bank" else None)
            rec.setdefault("v6", {})[f"{fam} {key}"] = {
                "ops": len(h), "valid": out["valid"],
                "op_index": out["op_index"], "dispatches":
                    out["dispatches"], "appends": out["appends"],
                "wall_s": time.perf_counter() - t0,
                **({"e_pad": out["e_pad"], "escalations":
                    out["escalations"]} if fam == "sets" else {})}
    hs16, model16 = W.bank_batch(4, STREAM_LANES, n_accounts=8,
                                 n_transfers=512, n_reads=512)
    fused = [SW.make_session("wl-bank", model16) for _ in hs16]
    solo = [SW.make_session("wl-bank", model16) for _ in hs16]
    calls, walls = _beats(fused, hs16, STREAM_BEAT)
    for s, h in zip(solo, hs16):
        for i in range(0, len(h), STREAM_BEAT):
            s.append(h[i:i + STREAM_BEAT])
    same = [a.poll() == b.poll() and torch.equal(a._balance, b._balance)
            for a, b in zip(fused, solo)]
    vf = [s.close() for s in fused]
    for s in solo:
        s.close()
    rec["v6"]["bank megabatch"] = {
        "lanes": len(hs16), "beats": len(calls),
        "calls_per_beat": sorted({c for c, _, _ in calls}),
        "beat_wall_ms_median": _pct(walls, 0.5) * 1e3,
        "valid_lanes": sum(v["valid"] is True for v in vf),
        "bit_equal_to_solo": all(same)}
    return runs, (hs16, model16, vf, calls, same)


def _stream_restore(rec, wire, ck_at, h_a, live, dev):
    """(v7): (v1)'s 50% checkpoint, decoded from its wire form, restored
    on the card and on the CPU; both finish (a)."""
    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.stream import checkpoint as CK

    out = {}
    for label, device in (("card", None), ("cpu", "cpu")):
        t0 = time.perf_counter()
        s = StreamSession.restore(CK.from_wire(wire), device=device)
        for i in range(ck_at, len(h_a), STREAM_DELTA):
            s.append(h_a[i:i + STREAM_DELTA])
        v = s.finalize_input()
        same = (v == live.poll()
                and bool((s._eng.ws.cpu() == live._eng.ws.cpu()).all())
                and bool((s._eng.stat.cpu() == live._eng.stat.cpu()).all()))
        out[label] = same
        rec.setdefault("v7", {})[label] = {
            "wall_s": time.perf_counter() - t0, "equal_to_live": same,
            "valid": v["valid"], "device": str(s.device)}
    return out


def _stream_follow(rec, h_e):
    """(v8): (e)'s history written by a writer thread in 10 pieces, the
    last line unterminated, read by ``filetest --follow``; then
    ``filetest`` on the whole file."""
    import ast
    import contextlib
    import io
    import threading

    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.ops.history import history_to_edn

    d = tempfile.TemporaryDirectory(prefix="chip_smoke_follow_")
    path = os.path.join(d.name, "live.edn")
    open(path, "w").close()
    lines = history_to_edn(h_e).splitlines()
    step = -(-len(lines) // 10)

    def writer():
        for i in range(0, len(lines), step):
            with open(path, "a") as fh:
                text = "\n".join(lines[i:i + step])
                fh.write(text if i + step >= len(lines) else text + "\n")
            time.sleep(0.05)

    th = threading.Thread(target=writer)
    buf = io.StringIO()
    t0 = time.perf_counter()
    th.start()
    with contextlib.redirect_stdout(buf):
        rc = filetest.main([path, "--follow", "--follow-idle", "1.0",
                            "--follow-poll", "0.02"])
    th.join()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    final = ast.literal_eval(text[text.rindex("\n{") + 1:].strip())
    rc_whole = filetest.main([path])
    d.cleanup()
    rec["v8"] = {"exit": rc, "exit_whole_file": rc_whole,
                 "final": final, "wall_s": wall,
                 "appends": final.get("appends")}
    return rc, rc_whole, final


def _stream_path(dev, h_a, h_b, h_d, h_e, h_f):
    """The sixth path: (v1)-(v8) on the card through the port's
    streaming entry points; the launches' records for (v9)."""
    rec: dict = {}
    timer, syncs = _TimedLaunches(), _SyncCount()
    timer.install()
    syncs.install()
    try:
        t = time.perf_counter()
        live, wire, ck_at, v1 = _stream_live(rec, timer, syncs, h_a)
        n_v1 = len(timer.captured)
        v2, ce = _stream_invalid(rec, h_b)
        v3 = _stream_overflow(rec, h_d)
        v4 = _stream_wide(rec, h_f)
        mb = _stream_megabatch(rec, timer)
        wl = _stream_workloads(rec)
        v7 = _stream_restore(rec, wire, ck_at, h_a, live, dev)
        v8 = _stream_follow(rec, h_e)
        rec["wall_s"] = time.perf_counter() - t
    finally:
        syncs.uninstall()
        timer.uninstall()
    return rec, (timer.captured, n_v1), (live, v1, v2, ce, v3, v4, mb, wl,
                                         v7, v8)


def _stream_checks(rec, outs, a, b, d, f, h_a, h_e, dev):
    """The sixth path's verdicts against their one-shot oracles (run
    after the path's counts), its numbers printed, and the scratch
    re-check curve: ``analysis`` of (a)'s prefix from scratch at 25, 50,
    75 and 100%."""
    import torch

    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.stream import engine as TE

    live, v1, v2, ce, v3, v4, mb, wl, v7, v8 = outs
    r1 = rec["v1"]
    print(f"  v1: {r1['appends']} appends of {STREAM_DELTA} events: "
          f"valid={v1['valid']!r} engine={v1['engine']} "
          f"replays={v1['replays']} segments={v1['segments']}; per-append "
          f"wall median {r1['wall_ms']['median']:.3f} ms, p99 "
          f"{r1['wall_ms']['p99']:.3f} ms, first quarter "
          f"{r1['wall_ms']['first_quarter_mean']:.3f} ms, last quarter "
          f"{r1['wall_ms']['last_quarter_mean']:.3f} ms; card per append "
          f"{r1['card_ms']['mean']:.4f} ms mean (first quarter "
          f"{r1['card_ms']['first_quarter_mean']:.4f}, last "
          f"{r1['card_ms']['last_quarter_mean']:.4f}; CUDA events around "
          f"each launch); {r1['host_syncs_per_append']:.3f} host syncs "
          f"per append (max {r1['host_syncs_max']}); {r1['dispatches']} "
          f"dispatches (max {r1['dispatches_per_append_max']} per append); "
          f"carry {r1['carry_bytes']} bytes; card idle "
          f"{100 * r1['card_idle_share']:.2f}% of the appends' wall")
    _expect(v1["valid"] is True and a.valid is True
            and v1["final_count"] == a.final_count
            and v1["engine"] == "kernel" and v1["replays"] == 0
            and not r1["engines_tried"],
            f"(v1) {r1['verdict']} differs from (a) (valid={a.valid!r}, "
            f"n={a.final_count}) or left the kernel rung")
    _expect(r1["dispatches_per_append_max"] == 1
            and r1["host_syncs_max"] <= 2,
            f"(v1) more than one launch or two host syncs per append: {r1}")
    # the scratch curve: a from-scratch re-check of the prefix (one
    # unrecorded call first, so no point pays the first call's costs)
    analysis(cas_register(), h_a[:len(h_a) // 4])
    curve = []
    for pct in (25, 50, 75, 100):
        n = len(h_a) * pct // 100
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = analysis(cas_register(), h_a[:n])
        torch.cuda.synchronize()
        curve.append({"percent": pct, "events": n, "valid": res.valid,
                      "wall_ms": (time.perf_counter() - t0) * 1e3})
    r1["scratch_recheck"] = curve
    print("  v1 scratch re-check of the prefix (analysis from scratch): "
          + ", ".join(f"{c['percent']}% {c['wall_ms']:.1f} ms"
                      for c in curve)
          + f" — against {r1['wall_ms']['median']:.3f} ms per append")
    r2 = rec["v2"]
    print(f"  v2: valid={v2['valid']!r} op_index={v2['op_index']} (b: "
          f"{b.op_index}); latched at append {r2['latched_at_append']}, "
          f"{r2['appends_after_latch']} appends after it dispatched "
          f"nothing; counterexample {r2['counterexample_s']:.2f} s")
    _expect(v2["valid"] is False and v2["op_index"] == b.op_index
            and ce is not None and ce.op_index == b.op_index
            and ce.configs == b.configs
            and ce.paths == b.info.get("paths"),
            f"(v2) {r2} or its counterexample differs from (b)'s")
    r3 = rec["v3"]
    print(f"  v3: {r3['verdict']} tried {r3['engines_tried']} "
          f"wall {r3['wall_s']:.2f} s")
    tried = r3["engines_tried"] or [{}]
    _expect(v3["valid"] is d.valid is True and v3["engine"] == "xla"
            and v3["replays"] == 1
            and tried[0].get("engine") == "stream-kernel"
            and tried[0].get("note") == "frontier overflow"
            and v3["frontier_capacity"] > TE.STREAM_CAPACITIES[0],
            f"(v3) not one kernel overflow, one replay and an in-place "
            f"escalation to a VALID verdict: {r3}")
    r4 = rec["v4"]
    print(f"  v4: {r4['verdict']} ({r4['events']} events) wall "
          f"{r4['wall_s']:.2f} s")
    _expect(v4["valid"] is f.valid is True and v4["engine"] == "mxu"
            and v4["frontier_capacity"] == 131072
            and v4["final_count"] == f.final_count,
            f"(v4) differs from (f): {r4}")
    r5 = rec["v5"]
    for label, (calls, vf, same) in mb.items():
        print(f"  v5 {label}: {r5[label]}")
        _expect(all(same), f"(v5) {label}: lanes "
                f"{[i for i, s in enumerate(same) if not s]} differ from "
                f"the same sessions run solo")
        _expect(all(c == 1 for c, _, _ in calls),
                f"(v5) {label}: calls per beat {[c for c, _, _ in calls]}")
        _expect(r5[label]["rungs"] == [label],
                f"(v5) {label}: lanes ran on {r5[label]['rungs']}")
    _expect(r5["kernel"]["lanes_per_call"] == [STREAM_LANES],
            f"(v5) the kernel lanes were not one call: {r5['kernel']}")
    runs, (hs16, model16, vf16, calls16, same16) = wl
    for (fam, key), (h, out, model) in runs.items():
        want = W.check_wl_batch([h], fam, model, device=dev)[0]
        _expect(out["valid"] == want["valid?"],
                f"(v6) {fam} {key}: stream {out['valid']!r}, "
                f"check_wl_batch {want['valid?']!r}")
    want16 = W.check_wl_batch(hs16, "bank", model16, device=dev)
    _expect(all(same16) and all(c == 1 for c, _, _ in calls16)
            and [v["valid"] for v in vf16]
            == [w["valid?"] for w in want16],
            f"(v6) bank megabatch: {rec['v6']['bank megabatch']}")
    _expect(rec["v6"]["sets valid"]["e_pad"] == 8192
            and rec["v6"]["sets valid"]["escalations"] == 2,
            f"(v6) sets did not climb to the 8192 rung in place: "
            f"{rec['v6']['sets valid']}")
    print(f"  v6: {rec['v6']}")
    print(f"  v7: {rec['v7']}")
    _expect(all(v7.values()), f"(v7) restored sessions differ from the "
            f"live one: {rec['v7']}")
    rc, rc_whole, final = v8
    want_e = analysis(cas_register(), h_e)
    print(f"  v8: filetest --follow exit {rc} ({final}), whole file "
          f"exit {rc_whole}; wall {rec['v8']['wall_s']:.2f} s")
    _expect(rc == rc_whole and final["valid"] == want_e.valid
            and (want_e.valid is True
                 or final["op_index"] == want_e.op_index),
            f"(v8) --follow exit {rc} / {final} differ from the whole "
            f"file's exit {rc_whole} and analysis ({want_e.valid!r}, "
            f"{want_e.op_index})")


def _stream_parity(captured, n_v1):
    """(v9): every captured launch — the first STREAM_PARITY appends of
    (v1), then each lane of one fused (v5) beat — against the plain
    version on the same card tensors: ``ws_out`` and ``stat_out`` bit
    for bit. Returns (max abs error, launches compared, plain ms)."""
    import torch

    from comdb2_tpu_torch.checker import seg_kernel as SK

    err, t0 = 0, time.perf_counter()
    for k, ((seg, off, stride, ws, stat, table, spec), (ws_k, st_k)) \
            in enumerate(captured):
        status, fail, n, ws_p = SK.seg_search_reference(
            seg, off, stride, ws, stat, table, spec)
        st_p = [status, fail, n, int(stat[3])]
        bad = (not torch.equal(ws_p, ws_k)) or st_p != st_k.tolist()
        if bad:
            where = "v1" if k < n_v1 else "v5"
            raise _Failed(f"(v9) {where} launch {k}: kernel "
                          f"{st_k.tolist()} vs plain {st_p}, frontier "
                          f"{'equal' if torch.equal(ws_p, ws_k) else 'differs'}")
        err = max(err, int((ws_p.long() - ws_k.long()).abs().max()))
    return err, len(captured), (time.perf_counter() - t0) * 1e3


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
    import numpy as np

    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.checker import analysis, linear_host
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import pair_sort as PSORT
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.checker.wl import batch as WB
    from comdb2_tpu_torch.kernels import build
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import synth_columnar as SC
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import mutate, register_history
    from comdb2_tpu_torch.stream import engine as TE
    from comdb2_tpu_torch.txn import closure_torch as TCL
    from comdb2_tpu_torch.utils import next_pow2, queued_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    int32_rate = _int32_ops_per_s(dev)
    print(f"int32 rate for the bounds: {int32_rate:.4e} op/s "
          f"({INT32_LANES_PER_SM} lanes x SMs x max SM clock); HBM "
          f"{HBM_BYTES_PER_S:.3e} B/s")
    native_build = _start_native_build()
    t = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {', '.join(f'{n}.cu' for n in build.SOURCES)} for "
          f"sm_90a in {time.perf_counter() - t:.1f} s (one nvcc each, "
          "in parallel)")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    h_f = SC.pack_register_columns(SC.wide_register_batch_columns(
        1009, 1, 1, 1, 16, values=16))[0]
    print(f"histories generated in {time.perf_counter() - t:.1f} s")
    edn_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    edn_path = os.path.join(edn_dir.name, "history.edn")
    with open(edn_path, "w") as fh:
        fh.write(history_to_edn(h_e))
    packed_e = pack_history(h_e)
    want_e = linear_host.check(memo(cas_register(), packed_e),
                               packed_e).valid
    want_rc = 0 if want_e else 1

    def zero_counts():
        SK.LAUNCHES = SK.STREAM_LAUNCHES = PSORT.LAUNCHES = 0
        TCL.DISPATCHES = WB.DISPATCHES = 0
        TE.DISPATCHES = TE.MEGABATCHES = 0

    def counts():
        return {"seg_search": SK.LAUNCHES,
                "seg_search[stream]": SK.STREAM_LAUNCHES,
                "pair_sort": PSORT.LAUNCHES,
                "closure_diag": TCL.DISPATCHES, "wl_check": WB.DISPATCHES,
                "stream_dispatch": TE.DISPATCHES,
                "stream_megabatch": TE.MEGABATCHES}

    # --- path 1: single-history analysis, counted ---------------------------
    results = {}
    zero_counts()

    def run(name, h, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = analysis(cas_register(), h, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = {"valid": a.valid, "op_index": a.op_index,
                         "final_count": a.final_count,
                         "engine": a.info.get("engine"),
                         "frontier_capacity":
                             a.info.get("frontier_capacity"),
                         "effective_slots": a.info.get("effective_slots"),
                         "paths": len(a.info.get("paths", [])),
                         "engines_tried": a.info.get("engines_tried"),
                         "wall_s": wall}
        print(f"request {name}: valid={a.valid!r} op_index={a.op_index} "
              f"engine={a.info.get('engine')} "
              f"F={a.info.get('frontier_capacity')} "
              f"slots={a.info.get('effective_slots')} "
              f"tried={a.info.get('engines_tried')} "
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
    native_state = _finish_native_build(native_build)
    t0 = time.perf_counter()
    rc_e = filetest.main([edn_path])
    results["e"] = {"exit": rc_e, "want": want_rc,
                    "wall_s": time.perf_counter() - t0}
    print(f"request e: filetest exit {rc_e} (want {want_rc})")
    # (e3): the same request with --trace, for the host breakdown
    trace_path = os.path.join(edn_dir.name, "trace.json")
    t0 = time.perf_counter()
    rc_e3 = filetest.main([edn_path, "--trace", trace_path])
    wall_e3 = time.perf_counter() - t0
    stages_e3, parser_e3, dropped_e3 = _trace_stages(trace_path)
    edn_dir.cleanup()
    results["e3"] = {"exit": rc_e3, "wall_s": wall_e3, "parser": parser_e3,
                     "native_build": native_state, "stages_ms": stages_e3,
                     "dropped_spans": dropped_e3}
    print(f"request e3: filetest --trace exit {rc_e3}, wall {wall_e3:.3f} "
          f"s, parser {parser_e3} (native build: {native_state}); span "
          f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in stages_e3.items()))
    f = run("f", h_f, backend="device")
    launches = SK.LAUNCHES
    path_counts = {"single-history": counts()}

    checks = [
        (a.valid is True and a.info.get("engine") == "cuda-seg",
         f"(a) not VALID through cuda-seg: {results['a']}"),
        (b is not None and b.op_index is not None
         and b.info.get("engine") == "cuda-seg"
         and len(b.info.get("paths", [])) > 0,
         "(b) no INVALID with op index and paths from cuda-seg"),
        (c.valid is True and c.info.get("engine") == "cuda-seg",
         f"(c) not VALID through cuda-seg: {results['c']}"),
        (d.info.get("effective_slots", 0) >= 8
         and (d.info.get("engines_tried") or [None])[0]
         == {"engine": "cuda-seg", "frontier_capacity": 128}
         and d.info.get("engine") == "torch-seg2" and d.valid is True,
         f"(d) not tried on the kernel first and decided VALID by the "
         f"seg2 ladder: {results['d']}"),
        (rc_e == want_rc, f"(e) filetest exit {rc_e}, want {want_rc}"),
        (rc_e3 == rc_e and dropped_e3 == 0
         and {"filetest.parse", "linear.pack", "linear.device",
              "linear.kernel", "filetest.finalize"} <= set(stages_e3),
         f"(e3) filetest --trace exit {rc_e3} (without: {rc_e}) or stage "
         f"spans missing: {results['e3']}"),
        (f.valid is True and f.info.get("engine") == "mxu-frontier"
         and f.info.get("frontier_capacity") == 131072
         and f.final_count == 1,
         f"(f) not VALID from mxu-frontier at 131072: {results['f']}"),
        (launches > 0, "the single-history path launched no kernel"),
    ]
    for name, res in (("a", a), ("b", b), ("c", c), ("d", d), ("f", f)):
        want = RECORDED[name]
        got = (res.valid, res.op_index if want[1] is not None else None,
               res.info.get("engine"), res.info.get("frontier_capacity"))
        checks.append((got == want, f"({name}) {got} differs from the "
                                    f"recorded {want}"))
    for ok, msg in checks:
        if not ok:
            return _fail(msg)
    print(f"b: first INVALID mutate seed {b_seed}")
    print(f"LAUNCHES seg_search (single-history path): {launches}")

    # --- (d'): seg2 on the card against seg2 on CPU tensors ---------------
    packed_d = pack_history(h_d)
    mm_d = memo(cas_register(), packed_d)
    segs_d = LT.make_segments(packed_d)
    segs_d = LT.make_segments(
        packed_d, s_pad=next_pow2(segs_d.ok_proc.shape[0], 64),
        k_pad=next_pow2(segs_d.inv_proc.shape[1], 2))
    segs_d, pe_d = LT.remap_slots(segs_d)
    P2_d = max(pe_d + (pe_d & 1), 2)
    succ_d = LT.pad_succ(mm_d.succ, next_pow2(mm_d.succ.shape[0]),
                         next_pow2(mm_d.succ.shape[1]))
    kw_d = dict(F=d.info["frontier_capacity"], Fs=32, P=P2_d,
                n_states=mm_d.n_states, n_transitions=mm_d.n_transitions)
    args_d = (succ_d, segs_d.inv_proc, segs_d.inv_tr, segs_d.ok_proc,
              segs_d.depth)
    t0 = time.perf_counter()
    r_full = LT.check_device_seg2(*args_d, device=dev, **kw_d)
    t_full = time.perf_counter() - t0
    # the CPU side, at about 37 ms a segment, on (d)'s first D_PRIME
    # segments, both sides from the same initial carry
    args_p = (succ_d, *(a[:D_PRIME] for a in args_d[1:]))
    t0 = time.perf_counter()
    r_gpu = LT.check_device_seg2(*args_p, device=dev, **kw_d)
    t_gpu = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    r_cpu = LT.check_device_seg2(*args_p, device="cpu", **kw_d)
    t_cpu = time.perf_counter() - t0
    torch.set_num_threads(threads)
    results["d'"] = {"F": kw_d["F"], "card_all": r_full,
                     "card_all_s": t_full, "segments": D_PRIME,
                     "card": r_gpu, "cpu": r_cpu, "card_s": t_gpu,
                     "cpu_s": t_cpu}
    print(f"request d': seg2 at F={kw_d['F']} on the card {r_full} in "
          f"{t_full:.2f} s; on the first {D_PRIME} segments, on the card "
          f"{r_gpu} in {t_gpu:.2f} s, on CPU tensors {r_cpu} in "
          f"{t_cpu:.2f} s")
    if r_gpu != r_cpu or r_full[0] != LT.VALID or r_gpu[0] != LT.VALID:
        return _fail(f"(d') seg2 on the card {r_gpu} != on CPU {r_cpu}, "
                     f"or not VALID (all of (d) on the card: {r_full})")

    # --- path 2: batches, counted -----------------------------------------
    t0 = time.perf_counter()
    cols = SC.register_batch_columns(11_000_000, G_HISTORIES, G_OPS,
                                     n_procs=5, values=5)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    packeds_g = SC.pack_register_columns(cols)
    del cols
    batch_g = TB.pack_batch(packeds_g, cas_register(), build_streams=False)
    t_pack = time.perf_counter() - t0
    n_ops_g = sum(int((p.type == 0).sum()) for p in packeds_g)
    t0 = time.perf_counter()
    for p in packeds_g:
        p._segments_exact = LT.make_segments(p)
    t_seg = time.perf_counter() - t0
    t0 = time.perf_counter()
    TB._stream_segments(batch_g)
    t_remap = time.perf_counter() - t0
    rng7 = random.Random(7)
    batch_g2 = TB.pack_batch(
        [register_history(rng7, n_procs=5, n_events=800, values=5,
                          p_info=0.0) for _ in range(256)], cas_register())
    hs_h = _h_histories()
    batch_h = TB.pack_batch(hs_h, cas_register())
    hs_h10 = _h10_histories()
    batch_h10 = TB.pack_batch(hs_h10, cas_register())
    # the widest rows the keys engine sorts on each counted path, for
    # the pair_sort parity below
    captured = {"h": {}, "j2": {}}
    sort_fn = PSORT.pair_sort

    def capturing_sort(into):
        def sort(hi, lo):
            if hi.numel() > into.get("numel", 0):
                into.update(numel=hi.numel(), hi=hi.clone(), lo=lo.clone())
            return sort_fn(hi, lo)
        return sort

    PSORT.pair_sort = capturing_sort(captured["h"])
    zero_counts()
    batch_res = {}

    def run_batch(name, batch, F):
        info: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, fa, n = TB.check_batch(batch, F=F, info=info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        batch_res[name] = {"F": F, "histories": len(batch),
                           "wall_s": wall, "engine": info.get("engine"),
                           "stream": info.get("stream"),
                           "escalated": info.get("escalated"),
                           "status_counts": {int(k): int(v) for k, v in zip(
                               *np.unique(st, return_counts=True))}}
        print(f"request {name}: {len(batch)} histories F={F} "
              f"engine={info.get('engine')} stream={info.get('stream')} "
              f"escalated={info.get('escalated')} "
              f"statuses={batch_res[name]['status_counts']} "
              f"wall {wall:.3f} s")
        return st, fa, n, info

    st_g, _, _, info_g = run_batch("g", batch_g, 128)
    st_g2, _, _, info_g2 = run_batch("g2", batch_g2, 256)
    st_h, fa_h, _, info_h = run_batch("h", batch_h, 8192)
    st_h10, fa_h10, _, info_h10 = run_batch("h10", batch_h10, 8192)
    stream_launches = SK.STREAM_LAUNCHES
    sort_launches = PSORT.LAUNCHES
    path_counts["batch"] = counts()
    PSORT.pair_sort = sort_fn
    batch_res["g"]["host_s"] = {"generate": t_gen, "pack": t_pack,
                                "segments": t_seg, "remap": t_remap}
    batch_res["g"]["ops"] = n_ops_g
    print(f"  g host: generate {t_gen:.2f} s, pack {t_pack:.2f} s, "
          f"segments {t_seg:.2f} s, remap {t_remap:.2f} s; "
          f"{n_ops_g} ops")
    print(f"LAUNCHES seg_search[stream] (batch path): {stream_launches}; "
          f"pair_sort: {sort_launches}")

    # every (h) and (h10) lane against its own single-history analysis
    lanes, mismatched = _lanes_vs_analysis(hs_h, st_h, fa_h)
    batch_res["h"]["lanes_mismatched"] = mismatched
    batch_res["h"]["invalid_lanes"] = sum(1 for s_, _, _ in lanes
                                          if s_ == LT.INVALID)
    lanes10, mismatched10 = _lanes_vs_analysis(hs_h10, st_h10, fa_h10)
    batch_res["h10"]["lanes_mismatched"] = mismatched10
    batch_res["h10"]["invalid_lanes"] = sum(1 for s_, _, _ in lanes10
                                            if s_ == LT.INVALID)
    checks = [
        (bool((st_g == LT.VALID).all()) and info_g.get("engine") == "stream"
         and info_g["stream"]["groups"] >= MIN_STREAMS,
         f"(g) not all VALID through the stream kernel on >= {MIN_STREAMS} "
         f"warp streams: {batch_res['g']}"),
        (bool((st_g2 == LT.VALID).all())
         and info_g2.get("engine") == "stream",
         f"(g2) not all VALID through the stream kernel: "
         f"{batch_res['g2']}"),
        (info_h.get("engine") == "stream"
         and (info_h.get("escalated") or {}).get("engine") == "keys"
         and info_h["escalated"]["count"] == 8,
         f"(h) the 8 overflowing lanes did not escalate through keys: "
         f"{batch_res['h']}"),
        (not mismatched, f"(h) lanes {mismatched} differ from their "
         f"single-history analysis: {[lanes[i] for i in mismatched]}"),
        (batch_res["h"]["invalid_lanes"] > 0, "(h) has no INVALID lane"),
        (info_h10.get("engine") == "stream"
         and (info_h10.get("escalated") or {}).get("engine") == "mxu"
         and info_h10["escalated"]["count"] == 4,
         f"(h10) the 10-process lanes did not escalate through mxu: "
         f"{batch_res['h10']}"),
        (not mismatched10, f"(h10) lanes {mismatched10} differ from "
         f"their single-history analysis: "
         f"{[lanes10[i] for i in mismatched10]}"),
        (stream_launches > 0, "the batch path launched no stream kernel"),
        *[(batch_res[k]["status_counts"] == v, f"({k}) statuses "
           f"{batch_res[k]['status_counts']} differ from the recorded {v}")
          for k, v in RECORDED_BATCHES.items()],
        (sort_launches > 0, "the batch path launched no pair_sort"),
    ]
    for ok, msg in checks:
        if not ok:
            return _fail(msg)

    # --- path 3: the checker layer, counted -------------------------------
    print("checker layer: closure (t), check_txn (t2), workload families "
          "(w), IndependentChecker (i), filetest --checker (e2)")
    zero_counts()
    try:
        checker_rec = _checker_layer(dev)
    except _Failed as e:
        return _fail(str(e))
    path_counts["checker layer"] = counts()
    # the single-history launches that held (i)'s keys against their own
    # analysis are a comparison, not the path's
    path_counts["checker layer"]["seg_search"] -= \
        checker_rec["i"]["comparison_launches"]
    print(f"LAUNCHES (checker-layer path): {path_counts['checker layer']}")
    if not (path_counts["checker layer"]["seg_search[stream]"] > 0
            and path_counts["checker layer"]["closure_diag"] > 0
            and path_counts["checker layer"]["wl_check"] > 0):
        return _fail(f"the checker-layer path launched no stream kernel, "
                     f"closure or wl program: {path_counts}")

    # --- path 4: the last batch engines, counted --------------------------
    print("last batch engines: (j) stream kernel + vmap escalation, (j2) "
          "flat / vmap / keys")
    PSORT.pair_sort = capturing_sort(captured["j2"])
    zero_counts()
    t0 = time.perf_counter()
    escal_rec: dict = {}
    try:
        j_args = _escalation_requests(dev, escal_rec)
        path_counts["last batch engines"] = counts()
        PSORT.pair_sort = sort_fn
        _escalation_comparisons(dev, escal_rec, *j_args)
    except _Failed as e:
        return _fail(str(e))
    PSORT.pair_sort = sort_fn
    hs_j, batch_j, info_j = j_args[:3]
    del j_args
    print(f"  (path 4 took {time.perf_counter() - t0:.1f} s)")
    print(f"LAUNCHES (last-batch-engines path): "
          f"{path_counts['last batch engines']}")
    if not (path_counts["last batch engines"]["seg_search[stream]"] > 0
            and path_counts["last batch engines"]["pair_sort"] > 0):
        return _fail(f"the last-batch-engines path launched no stream "
                     f"kernel or pair sort: {path_counts}")

    # --- path 5: shrink, counted ------------------------------------------
    print("shrink: minimize (s10) 10k and (s) 100k events, txn minimal "
          "cycles (st), filetest --shrink (sf), checker artifacts (sa)")
    zero_counts()
    t0 = time.perf_counter()
    try:
        shrink_rec, batch_s = _shrink_path(dev, h_b)
    except _Failed as e:
        return _fail(str(e))
    path_counts["shrink"] = counts()
    print(f"  (path 5 took {time.perf_counter() - t0:.1f} s)")
    print(f"LAUNCHES (shrink path): {path_counts['shrink']}")
    if not (path_counts["shrink"]["seg_search[stream]"] > 0
            and path_counts["shrink"]["closure_diag"] > 0):
        return _fail(f"the shrink path launched no stream kernel or "
                     f"closure: {path_counts}")

    # --- path 6: streaming sessions, counted ------------------------------
    print("stream: (v1) live appends of (a), (v2) its INVALID twin, (v3) "
          "overflow and replay, (v4) wide P, (v5) megabatch, (v6) workload "
          "sessions, (v7) checkpoint and restore, (v8) filetest --follow")
    zero_counts()
    t0 = time.perf_counter()
    try:
        stream_rec, stream_cap, stream_out = _stream_path(
            dev, h_a, h_b, h_d, h_e, h_f)
        path_counts["stream"] = counts()
        print(f"LAUNCHES (stream path): {path_counts['stream']}")
        _stream_checks(stream_rec, stream_out, a, b, d, f, h_a, h_e, dev)
    except _Failed as e:
        return _fail(str(e))
    del stream_out
    print(f"  (path 6 took {time.perf_counter() - t0:.1f} s, "
          f"{stream_rec['wall_s']:.1f} s of it the counted requests)")
    if not (path_counts["stream"]["seg_search"] > 0
            and path_counts["stream"]["stream_megabatch"] > 0):
        return _fail(f"the stream path launched no segment-search kernel "
                     f"or no megabatch: {path_counts}")

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
        if name == "c":
            _, err = _deep_window(mm, packed, dev, results["c"])
            max_err = max(max_err, err)
    max_err = max(max_err, _rare_paths(dev, results))
    try:
        err_v9, n_v9, plain_v9 = _stream_parity(*stream_cap)
    except _Failed as e:
        return _fail(str(e))
    del stream_cap
    max_err = max(max_err, err_v9)
    stream_rec["v9"] = {"launches": n_v9, "v1_launches": STREAM_PARITY,
                        "plain_ms": plain_v9, "max_abs_err": err_v9}
    print(f"  v9: {n_v9} stream-path launches (the first {STREAM_PARITY} "
          f"appends of (v1), each lane of one fused (v5) beat) bit-equal "
          f"to seg_search_reference on the same card tensors (plain "
          f"version {plain_v9:.1f} ms for all)")
    tier = results["d"]["parity"]["spec"]
    if (tier["rows"], tier["n_words"]) != (16, 3):
        return _fail(f"(d) did not run the 16-row, 3-word tier: {tier}")
    ms, plain_ms, work, nbytes, spec = head
    bound_ms, bound_by = _bound(
        nbytes, SK.needed_compares(work.ms, spec.P) * spec.n_words,
        int32_rate)
    entries = [{
        "name": "seg_search", "route": "cuda",
        "source": "comdb2_tpu_torch/kernels/seg_search.cu",
        "replaces": "comdb2_tpu/checker/pallas_seg.py:561",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "parity": "bit-equal (status, fail, n, frontier)",
        "measured_on": f"request (a), segments [0, {WINDOW})",
        "stream_path": {"parity_launches": stream_rec["v9"]["launches"],
                        "card_ms_per_append":
                            stream_rec["v1"]["card_ms"]["mean"]}}]

    # stream mode, at the main path's own launch shapes: (h)'s whole
    # launch, two of (g)'s group streams together at (g)'s layout, and
    # one group stream of nine (h) histories with an INVALID and an
    # overflowing one in the middle
    def stream_inputs(batch, info_b):
        streams, _ = TB._stream_segments(batch)
        sizes = dict(n_states=batch.memo.n_states,
                     n_transitions=batch.memo.n_transitions)
        spec_b = TB._slice_spec(streams, sizes)
        table = torch.from_numpy(SK.pack_table(
            batch.memo.succ[:sizes["n_states"],
                            :sizes["n_transitions"]])).to(dev)
        groups = SK.default_groups(len(streams), spec_b, table.numel(), dev)
        t0 = time.perf_counter()
        seg, plan, _ = SK.pack_groups(streams, spec_b, groups)
        t_pack = time.perf_counter() - t0
        if (len(plan), seg.shape[1]) != (info_b["stream"]["groups"],
                                         info_b["stream"]["rows"]):
            raise AssertionError(f"re-packed launch {len(plan)} x "
                                 f"{seg.shape[1]} != the main path's "
                                 f"{info_b['stream']}")
        return (streams, sizes["n_transitions"], spec_b, table,
                torch.from_numpy(seg).to(dev), plan, t_pack)

    def stream_check(label, seg, stride, table, spec_b, n_hist):
        """Kernel vs plain version on one launch: bit-equal results per
        history, and per-stream work and need. Returns (results, work,
        need, plain ms, max abs err)."""
        work_k = torch.zeros(seg.shape[0], dtype=torch.int64, device=dev)
        need_k = torch.zeros_like(work_k)
        got_k = SK.seg_search_stream(seg, stride, table, spec_b, n_hist,
                                     work=work_k, need=need_k)
        torch.cuda.synchronize()
        want_k = torch.zeros_like(got_k)
        ws0 = torch.from_numpy(SK.initial_frontier(spec_b)).to(dev)
        st0 = torch.from_numpy(SK._init_stat()).to(dev)
        recs = []
        t0 = time.perf_counter()
        for g_ in range(seg.shape[0]):
            recs.append(_MRecorder())
            SK.seg_search_reference(seg[g_], 0, stride, ws0, st0, table,
                                    spec_b, work=recs[-1],
                                    results=want_k[g_])
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err_k = int((got_k.long() - want_k.long()).abs().max())
        same = (torch.equal(got_k, want_k)
                and work_k.tolist() == [r.get("compares", 0) for r in recs]
                and need_k.tolist() == [SK.needed_compares(r.ms, spec_b.P)
                                        for r in recs])
        print(f"  stream {label}: {seg.shape[0]} streams x {seg.shape[1]} "
              f"rows, {n_hist} histories per stream at most: "
              f"{'bit-equal' if same else 'DIFFERENT'} (status, fail, n), "
              f"work and need; plain version {plain:.1f} ms")
        if not same:
            raise AssertionError(f"seg_search[stream] differs from its "
                                 f"plain version on {label}")
        return got_k, work_k, need_k, plain, err_k

    (streams_h, stride_h, spec_h, table_h, seg_h, plan_h,
     _) = stream_inputs(batch_h, info_h)
    nh_h = max(len(g_) for g_ in plan_h)
    got_h, work_h, need_h, plain_ms_s, err_s = stream_check(
        "(h) whole launch", seg_h, stride_h, table_h, spec_h, nh_h)
    ms_s = _time_cuda(lambda: SK.seg_search_stream(
        seg_h, stride_h, table_h, spec_h, nh_h), 5)
    bound_s, by_s = _bound(4 * (seg_h.numel() + table_h.numel()
                                + got_h.numel()),
                           int(need_h.sum()) * spec_h.n_words, int32_rate)

    five = [i for i in range(len(hs_h)) if len(batch_h.packeds[i]
                                                  .process_table) == 5]
    valid5 = [i for i in five if int(st_h[i]) == LT.VALID]
    invalid5 = [i for i in five if int(st_h[i]) == LT.INVALID]
    over = [i for i in range(len(hs_h)) if i not in five]
    group = valid5[:3] + invalid5[:1] + over[:1] + valid5[3:7]
    seg_np, _, _ = SK.pack_groups([streams_h[i] for i in group], spec_h, 1)
    got, _, _, _, e_ = stream_check(
        f"one group of {len(group)} (h) histories",
        torch.from_numpy(seg_np).to(dev), stride_h, table_h, spec_h,
        len(group))
    err_s = max(err_s, e_)
    verdicts = [tuple(r) for r in got[0].tolist()]
    print(f"    verdicts in stream order: {verdicts}")
    if (verdicts[3][0], verdicts[4][0]) != (LT.INVALID, LT.UNKNOWN) or \
            any(v[0] != LT.VALID for v in verdicts[:3] + verdicts[5:]):
        return _fail(f"stream group verdicts out of place: {verdicts}")

    err_s = max(err_s, _contended_union(dev, results))

    # the (g) launch itself, re-timed outside the counted path
    (streams_g, stride_g, spec_g, table_g, seg_g, plan_g,
     t_groups) = stream_inputs(batch_g, info_g)
    n_hist_g = max(len(g_) for g_ in plan_g)
    work_g = torch.zeros(seg_g.shape[0], dtype=torch.int64, device=dev)
    need_g = torch.zeros_like(work_g)
    res_g = SK.seg_search_stream(seg_g, stride_g, table_g, spec_g,
                                 n_hist_g, work=work_g, need=need_g)
    torch.cuda.synchronize()
    ms_g = _time_cuda(lambda: SK.seg_search_stream(
        seg_g, stride_g, table_g, spec_g, n_hist_g), 2)
    bound_g, by_g = _bound(4 * (seg_g.numel() + table_g.numel()
                                + res_g.numel()),
                           int(need_g.sum()) * spec_g.n_words, int32_rate)
    # two of (g)'s own group streams launched together: the longest,
    # and one holding a different number of histories (else the
    # shortest)
    real = [sum(streams_g[b].ok_proc.shape[0] for b in grp) + len(grp) + 1
            for grp in plan_g]
    gi = max(range(len(plan_g)), key=lambda g_: real[g_])
    others = [g_ for g_ in range(len(plan_g))
              if len(plan_g[g_]) != len(plan_g[gi])]
    gj = others[0] if others else min(range(len(plan_g)),
                                      key=lambda g_: real[g_])
    pick = torch.tensor([gi, gj], device=dev)
    got2, work2, need2, _, e_ = stream_check(
        f"(g) groups {gi} and {gj} ({len(plan_g[gi])} and "
        f"{len(plan_g[gj])} histories, {real[gi]} and {real[gj]} rows)",
        seg_g[pick].contiguous(), stride_g, table_g, spec_g, n_hist_g)
    err_s = max(err_s, e_)
    if not (torch.equal(got2, res_g[pick])
            and torch.equal(work2, work_g[pick])
            and torch.equal(need2, need_g[pick])):
        return _fail("(g)'s two group streams alone differ from the same "
                     "groups in the whole launch")
    # (j)'s launch, re-run outside the counted path: the group streams
    # that hold the overflowing (mutated) lanes 0 to J_OVERFLOW - 1, the
    # longest one and the one holding the last lane, held against the
    # plain version and against the same groups in the whole launch
    (streams_j, stride_j, spec_j, table_j, seg_j, plan_j,
     _) = stream_inputs(batch_j, info_j)
    n_hist_j = max(len(g_) for g_ in plan_j)
    res_j = SK.seg_search_stream(seg_j, stride_j, table_j, spec_j, n_hist_j)
    group_of = {b: g_ for g_, grp in enumerate(plan_j) for b in grp}
    real_j = [sum(streams_j[b].ok_proc.shape[0] for b in grp) + len(grp)
              for grp in plan_j]
    pick_j = sorted({group_of[i] for i in range(J_OVERFLOW)}
                    | {max(range(len(plan_j)), key=lambda g_: real_j[g_]),
                       group_of[len(hs_j) - 1]})
    pick = torch.tensor(pick_j, device=dev)
    got_j, _, _, _, e_ = stream_check(
        f"(j) {len(pick_j)} of its {len(plan_j)} group streams (lanes "
        f"0-{J_OVERFLOW - 1}, the longest, the last lane's)",
        seg_j[pick].contiguous(), stride_j, table_j, spec_j, n_hist_j)
    err_s = max(err_s, e_)
    if not torch.equal(got_j, res_j[pick]):
        return _fail("(j)'s picked group streams alone differ from the "
                     "same groups in the whole launch")
    over_j = [int(got_j[pick_j.index(group_of[i]),
                        plan_j[group_of[i]].index(i), 0])
              for i in range(J_OVERFLOW)]
    if any(v != LT.UNKNOWN for v in over_j):
        return _fail(f"(j) lanes 0-{J_OVERFLOW - 1} did not overflow the "
                     f"kernel: statuses {over_j}")
    # (s10) stale-read's first ddmin round, re-run outside the counted
    # path: its two candidates' launch against the plain stream version
    info_s: dict = {}
    st_s, _, _ = TB.check_batch(batch_s, F=SHRINK_F, info=info_s,
                                device=dev)
    (streams_s, stride_s, spec_s, table_s, seg_s, plan_s,
     _) = stream_inputs(batch_s, info_s)
    got_s, _, _, plain_ms_round, e_ = stream_check(
        f"(s10) first ddmin round ({len(batch_s)} candidates, "
        f"{sum(s.ok_proc.shape[0] for s in streams_s)} segments)",
        seg_s, stride_s, table_s, spec_s, max(len(g_) for g_ in plan_s))
    err_s = max(err_s, e_)
    shrink_rec["s10"]["round_plain_ms"] = plain_ms_round
    if st_s.tolist() != [LT.VALID, LT.INVALID]:
        return _fail(f"(s10) first round statuses {st_s.tolist()}, want "
                     f"the base half VALID and the anomaly's half INVALID")

    per_sm_g = SK.warp_streams_per_sm(spec_g, table_g.numel())
    batch_res["g"]["kernel"] = {
        "groups": int(seg_g.shape[0]), "rows_per_group": int(seg_g.shape[1]),
        "histories_per_group_max": n_hist_g, "warp_streams_per_sm": per_sm_g,
        "launch_geometry": SK.launch_geometry(
            int(seg_g.shape[0]),
            torch.cuda.get_device_properties(dev).multi_processor_count),
        "ms": ms_g,
        "bound_ms": bound_g, "bound_by": by_g,
        "compares": int(work_g.sum()), "need": int(need_g.sum()),
        "pack_groups_s": t_groups,
        "checked_ops_per_s": n_ops_g / (ms_g / 1e3)}
    batch_res["h"]["kernel"] = {
        "groups": int(seg_h.shape[0]), "rows_per_group": int(seg_h.shape[1]),
        "ms": ms_s, "plain_ms": plain_ms_s, "bound_ms": bound_s,
        "bound_by": by_s, "compares": int(work_h.sum()),
        "need": int(need_h.sum())}
    print(f"  g geometry: {per_sm_g} warp streams per SM, G = "
          f"{seg_g.shape[0]} group streams, at most {n_hist_g} histories "
          f"per stream; (CTAs, warps per CTA) = "
          f"{batch_res['g']['kernel']['launch_geometry']}")
    print(f"  g kernel: {seg_g.shape[0]} streams x {seg_g.shape[1]} rows, "
          f"{ms_g:.3f} ms (CUDA events, mean of 2), bound {bound_g:.5f} ms "
          f"({by_g}); {n_ops_g / (ms_g / 1e3):.0f} checked ops/s; "
          f"group packing {t_groups:.2f} s")
    print(f"  h kernel: {seg_h.shape[0]} streams x {seg_h.shape[1]} rows, "
          f"{ms_s:.3f} ms (CUDA events, mean of 5), plain {plain_ms_s:.1f}"
          f" ms, bound {bound_s:.5f} ms ({by_s})")
    entries.append({
        "name": "seg_search[stream]", "route": "cuda",
        "source": "comdb2_tpu_torch/kernels/seg_search.cu",
        "replaces": "comdb2_tpu/checker/pallas_seg.py:606",
        "launches": stream_launches, "max_abs_err": err_s,
        "ms": ms_s, "plain_ms": plain_ms_s, "bound_ms": bound_s,
        "bound_by": by_s, "library_ms": None,
        "parity": "bit-equal (status, fail, n) per history, work and "
                  "need",
        "measured_on": f"request (h)'s whole launch, "
                       f"{int(seg_h.shape[0])} warp streams",
        "batch_ms": ms_g, "batch_bound_ms": bound_g,
        "batch_bound_by": by_g,
        "batch_measured_on": f"(g), {int(seg_g.shape[0])} warp streams"})

    # pair_sort: the widest rows the keys engine sorted in (h) and in
    # (j2), random rows at the block-sort and the merge-pass widths, and
    # the corners of its schedule: all-equal and reversed rows, corner
    # words, rows of N = T and N = 2T, rows of one pair
    hi_c, lo_c = captured["h"]["hi"], captured["h"]["lo"]
    Bc, Nc = hi_c.shape
    T_ = PSORT.SMEM_N
    gen = torch.Generator(device="cpu").manual_seed(2)
    cases = [("h", hi_c, lo_c),
             ("j2", captured["j2"]["hi"], captured["j2"]["lo"])]
    for B_, N_ in ((256, 4096), (4, 131072), (1, T_), (1, 2 * T_), (3, 1)):
        hi_r = torch.randint(-8, 8, (B_, N_), generator=gen,
                             dtype=torch.int32)
        lo_r = torch.randint(-2**31, 2**31 - 1, (B_, N_), generator=gen,
                             dtype=torch.int32)
        hi_r[:, :N_ // 4] = 1 << 30
        lo_r[:, :N_ // 4] = 7
        cases.append((f"random {B_}x{N_}", hi_r.to(dev), lo_r.to(dev)))
    words = torch.tensor([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2,
                          2**31 - 1], dtype=torch.int32)
    cases += [
        ("all-equal", torch.full((Bc, Nc), -3, dtype=torch.int32,
                                 device=dev),
         torch.full((Bc, Nc), -2**31, dtype=torch.int32, device=dev)),
        ("h reversed", *(t.flip(1).contiguous()
                         for t in PSORT.pair_sort_reference(hi_c, lo_c))),
        ("corner words", *(words[torch.randint(0, 7, (2, 4 * T_),
                                               generator=gen)].to(dev)
                           for _ in range(2)))]
    err_p = 0
    for name, hi_, lo_ in cases:
        k_out = sort_fn(hi_, lo_)
        p_out = PSORT.pair_sort_reference(hi_, lo_)
        torch.cuda.synchronize()
        e = max(int((k_out[0].long() - p_out[0].long()).abs().max()),
                int((k_out[1].long() - p_out[1].long()).abs().max()))
        err_p = max(err_p, e)
        print(f"  pair_sort {name} {tuple(hi_.shape)}: "
              f"{'bit-equal' if e == 0 else f'max diff {e}'}")
        if e:
            return _fail(f"pair_sort differs from its plain version on "
                         f"{name}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PSORT.pair_sort_reference(hi_c, lo_c)
    torch.cuda.synchronize()
    plain_ms_p = (time.perf_counter() - t0) * 1e3
    key = (hi_c.long() << 32) | (lo_c.long() + 2**31)
    lib_sorted = torch.sort(key, dim=1).values
    ref = PSORT.pair_sort_reference(hi_c, lo_c)
    if not (torch.equal((lib_sorted >> 32).int(), ref[0])
            and torch.equal(((lib_sorted & 0xffffffff) - 2**31).int(),
                            ref[1])):
        return _fail("torch.sort on the int64 key is not the same sort")
    # in turns: kernel, library, library, kernel; the card queued ahead
    # of the host (a sleep kernel first), so host time does not show
    turns = [queued_ms(lambda: sort_fn(hi_c, lo_c), 20),
             queued_ms(lambda: torch.sort(key, dim=1), 20),
             queued_ms(lambda: torch.sort(key, dim=1), 20),
             queued_ms(lambda: sort_fn(hi_c, lo_c), 20)]
    ms_p, lib_ms_p = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    # the same turns back to back, not queued: the host's time per call
    # (the wrapper's launches and allocations), which each of the main
    # path's calls pays, shows where it exceeds the card's
    b2b = [_time_cuda(lambda: sort_fn(hi_c, lo_c), 20),
           _time_cuda(lambda: torch.sort(key, dim=1), 20),
           _time_cuda(lambda: torch.sort(key, dim=1), 20),
           _time_cuda(lambda: sort_fn(hi_c, lo_c), 20)]
    phases = PSORT.phase_ms(hi_c, lo_c, 20)
    lib_ps = build.load("pair_sort")
    attrs = PSORT.kernel_attrs(lib_ps)
    lg = Nc.bit_length() - 1
    # a sort of N pairs needs N * floor(log2 N) comparisons of two words
    bound_p, by_p = _bound(16 * Bc * Nc, 2 * Bc * Nc * lg, int32_rate)
    entries.append({
        "name": "pair_sort", "route": "cuda",
        "source": "comdb2_tpu_torch/kernels/pair_sort.cu",
        "replaces": "comdb2_tpu/checker/pallas_sort.py:54",
        "launches": sort_launches, "max_abs_err": err_p,
        "ms": ms_p, "plain_ms": plain_ms_p, "bound_ms": bound_p,
        "bound_by": by_p, "library_ms": lib_ms_p,
        "parity": "bit-equal (hi, lo)",
        "measured_on": f"(h), the widest keys-engine block sort "
                       f"{Bc}x{Nc}",
        "grid_launches_per_call": len(phases),
        "phase_ms": phases, "turns_ms": turns,
        "back_to_back_ms": (b2b[0] + b2b[3]) / 2,
        "library_back_to_back_ms": (b2b[1] + b2b[2]) / 2,
        "back_to_back_turns_ms": b2b, "kernel_attrs": attrs})
    print(f"  pair_sort {Bc}x{Nc}: kernel {ms_p:.5f} ms, torch.sort on the "
          f"int64 key {lib_ms_p:.5f} ms (in turns, kernel / library / "
          f"library / kernel: {' / '.join(f'{t:.5f}' for t in turns)}; "
          f"{lib_ms_p / ms_p:.2f}x), plain {plain_ms_p:.3f} ms, bound "
          f"{bound_p:.5f} ms ({by_p})")
    print(f"  pair_sort {Bc}x{Nc} back to back (host time per call "
          f"included): kernel {(b2b[0] + b2b[3]) / 2:.5f} ms, torch.sort "
          f"{(b2b[1] + b2b[2]) / 2:.5f} ms (in turns: "
          f"{' / '.join(f'{t:.5f}' for t in b2b)})")
    print(f"  pair_sort launches per call: {len(phases)} (block sort, then "
          f"{len(phases) - 1} merge passes); block sort {phases[0]:.5f} ms, "
          f"merge passes {' '.join(f'{p:.5f}' for p in phases[1:])} (sum "
          f"{sum(phases[1:]):.5f}; CUDA events around each launch, a "
          f"timing-only call)")
    print(f"  pair_sort per CTA: tile {lib_ps.pair_sort_tile()} keys, "
          f"{lib_ps.pair_sort_smem_bytes()} bytes of dynamic shared memory; "
          + "; ".join(f"{k}: {a['registers']} registers, "
                      f"{a['local_bytes']} bytes of spill per thread, "
                      f"{a['static_smem_bytes']} bytes of static shared "
                      f"memory" for k, a in attrs.items()))
    print(f"  request (h) wall {batch_res['h']['wall_s']:.4f} s, "
          f"{sort_launches} pair_sort calls in the batch path")

    for e in entries:
        e["launches_by_path"] = {path: c[e["name"]]
                                 for path, c in path_counts.items()}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"gpu": gpu, "requests": results, "batches": batch_res,
                   "checker_layer": checker_rec,
                   "last_batch_engines": escal_rec, "shrink": shrink_rec,
                   "stream": stream_rec,
                   "launches_by_path": path_counts,
                   "kernels": entries, "work": work, "bytes": nbytes,
                   "wall_s": time.perf_counter() - t_start}, fh, indent=1,
                  default=str)
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "comdb2_tpu")
                    or m.startswith(("jax.", "comdb2_tpu.")))
    if leaked:
        return _fail(f"JAX or the JAX package was imported: {leaked}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
