#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``comdb2_tpu_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds every kernel from the sources in the checkout (one ``nvcc``
per source, all at once), drives the port's main paths through their
public entry points (``checker.analysis``, ``filetest``,
``checker.batch.check_batch`` with every engine, the checker layer's
``txn.check_txn``, ``checker.wl.check_wl_batch`` and
``IndependentChecker``, ``shrink.minimize``, the streaming
sessions ``stream.StreamSession``, ``stream.engine.MegaBatch``,
``stream.wl`` and ``filetest --follow``, the verifier service and the
Jepsen harness's ``harness.core.run``, in process and against a
``sut_node`` cluster) at full size, holds every kernel against
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
- (w) ``check_wl_batch`` on 256 lanes per family at the top rungs
  (the batch padded to 512)
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

- (j) ``check_batch(engine="auto", F=8192)`` on 128 eight-process
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

The verifier service, counted as a seventh path (``service``): (sv1) a
``python -m comdb2_tpu_torch.service --backend cuda`` daemon on the card
and a burst of 256 check requests from 64 connections, every reply
equal to ``check_batch``; (sv2) txn, bank, stream-session, shrink and
overflowing requests on the same daemon; (sv3) ``VerifierCore`` in
process; (sv4) ``check_batch(mesh=make_mesh(1))``; (sv5) ``filetest
--service``; (sv6) a card-less ``--backend cuda`` daemon that must exit
before its ready line.

The Jepsen harness, counted as an eighth path (``harness``): the port's
``harness.core.run`` in process, ``nodes = []``, every test built with
its default device (the card), each test's store in a temporary
directory; every recorded history is re-checked by the same checkers
built at ``device="cpu"`` (the plain versions; (x2)'s in a child process
that overlaps the rest of the script), with equal verdicts, per-key
results and fail indices, and no result may hold an ``error``:

- (x1) ``workloads.comdb2.register_tester()`` at the reference's
  settings (concurrency 10, [w cas cas r] staggered 0.1 s on key 1, 10
  s, ``MemDB``): VALID; one key, so ``IndependentChecker`` checks it
  alone, through ``seg_search``'s single-history mode;
- (x2) the same over ``MemDB(chaos_unknown=0.01, chaos_fail=0.05)``: its
  info ops pend forever; VALID, with the info count, the effective slots
  and the engine of the answer;
- (x3) the ``jepsen.independent`` shape: ``concurrent_generator(5,
  itertools.count(), ...)`` on 100 clients, 200 ops of [w cas cas r] per
  key, no stagger, 10 s, with the first read of key 3 answered 99, a
  value no write puts (``_planted_read``): INVALID on key 3 alone, every
  key from one ``seg_search[stream]`` launch and key 3 re-checked alone
  through the single-history mode, at the planted read;
- (x4) (x1) with one read answered stale (``_StaleRead``: no other call
  open while it is): INVALID on key 1 from the single-history kernel,
  with ``linear.svg``, ``timeline.html`` and the perf SVGs in the store
  (copied to ``chiprun_out/harness_x4/``);
- (x5) ``sets_test`` over a lossy backend and ``g2_test`` over a broken
  one: both INVALID.

The TCP cluster, counted as a ninth path (``cluster``; the port's
``workloads.tcp`` clients, ``harness.provision`` and the nemeses against
real ``sut_node`` processes on ``127.0.0.1`` ports the OS hands out,
every node killed on the way out; ``native/build/sut_node`` is built
with cmake at the script's start when it is missing, and the path fails
without it):

- (c1) the reference suite's ``register-test-nemesis``: five nodes
  provisioned by ``SutNodeDB`` over ``LocalRemote``,
  ``TcpClusterRegisterClient(timeout_s=1.0, mutate_retries=8)``,
  concurrency 10, [w cas cas r] staggered 0.02 s on key 1 for 10 s,
  ``ClusterPartitioner(isolate_primary=True)`` in two 2 s windows, the
  tester's checkers on the card: VALID, its lone key through
  ``seg_search``'s single-history mode (``cuda-seg``) or the
  ``torch-seg2`` ladder after an overflow at 128, at most 16 effective
  slots; re-checked by the plain versions in a child process;
- (c2) the ``-B`` split-brain control of
  ``tests/test_replicated_sut.py`` (three nodes, 8 keys, 6 s, two 2 s
  windows; the reference's seeds in turn until one is caught):
  INVALID, from the stream launch and the failing keys' single-history
  launches;
- (c3) list-append over a three-node cluster for 4 s, checked by
  ``Serializable(backend="device")`` (the closure on the card): VALID,
  equal to the host checker.

Each run reports its harness wall (generation and the SUT), its check's
wall, the card's milliseconds in its launches (CUDA events,
``compile_guard.time_launches``), its launches, its history's size and
each key's engine and effective slots; paths 8 and 9 alike. Every
segment-search launch of either path is copied (``_LaunchLog``) and held
bit-equal to
``seg_search_reference``: each single-history launch on the same card
tensors; each stream launch's longest group and its groups with an
INVALID lane on the same card tensors, and every group on CPU copies of
them.

Static analysis on the card, counted as a tenth path (``static
analysis``): (an1) ``python -m comdb2_tpu_torch.analysis`` over the
port's tree exits 0, its per-pass times printed; (an2) the Hopper
budget read back from the built libraries at every production tier
(``analysis.kernel_budget.check_built``: the library's dynamic shared
memory equal to the Python mirror and within the card's opt-in limit,
at least 8 warp-streams per SM, no spill, at most 255 registers);
(an3) the kernel-surface prover's mixed workload
(``analysis.compile_surface.mixed_workload``) under the launch guard,
its variants inside the static inventory, every segment-search launch
held bit-equal to ``seg_search_reference`` and every pair sort to
``pair_sort_reference``, and a deliberately unbucketed pair-sort row
caught; (an4) ``scripts/torch_fuzz_seg.py --device cuda`` at 8 seeds
per family, the kernel against seg2 with no mismatch.

The elastic fleet and the port's gate, counted as an eleventh path
(``fleet``):

- (gt) ``scripts/check_torch.sh --json --device cuda`` in a child
  process started before path 9 and joined at the script's end:
  every stage ``ok`` (the port's static analysis, the txn / shrink /
  workload-family / MXU smokes, the mesh at D = 1, the daemon's
  service, stream, routing, elastic and tracing smokes, each daemon on
  the card);
- (el) ``scripts/torch_elastic.py``'s ``run`` on the card: the
  supervisor keeps two ``--backend cuda --frontier 1024`` daemons under
  ``ct_pmux``; a burst of its size classes, 32 of (i)'s keys and one of
  (h)'s overflowing 8-process lanes; one daemon SIGKILLed a third of the
  way in (the survivor serves its classes, the corpse is reaped, its
  registration deleted, the epoch bumped, the floor refilled); a third
  daemon joins under a second burst (about 1/3 of 512 probe keys remap,
  all onto it); a session on the kernel rung, one more of (i)'s keys in
  two appends, moves by checkpoint off a draining daemon with 0 replays;
  the client-observed fleet history checked VALID by the fleet. Every
  reply equal to the in-process ``check_batch`` on the card; each
  daemon's launches and card time read from its ``metrics`` verb; the
  stream kernel, the carry mode and the pair sort launched in the fleet;
  no daemon, zombie or compute app of a daemon left. The daemons' stderr
  files go to ``chiprun_out/fleet_daemons/``;
- (mz) ``scripts/torch_fuzz_mxu.py``'s ``run`` at 6 seeds per family
  on the card, in a thread beside (el): PASS, both verdict classes in each family, no UNKNOWN in
  the wave families, the kernel cross-checked on register seeds, and
  every segment-search launch it made held bit-equal to
  ``seg_search_reference``.

In the single-history path, (e3) is (e) again with ``filetest --trace``:
the span totals per stage (parse, pack, device with segments / kernel /
decode inside, finalize) and the parser that ran — the C++ loader when
``native/build/libct_sut.so`` is built (the script builds it, and
``sut_node``, with
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

import contextlib
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
WL_LANES = 256         # (w): bank lanes, padded to the top rung
WL_GEN_LANES = 64      # (w): sets / dirty lanes (their host encoding dominates)
CLOSURE_RT_N = 2048    # (t): the realtime plane's runs (dense host SCCs)
ANALYSIS_FUZZ_SEEDS = 8   # (an4): seeds per family
KEYS, KEY_EVENTS = 256, 2000                                 # (i)
J_LANES, J_EVENTS, J_OVERFLOW, J_F = 128, 2000, 8, 8192     # (j), (j2)
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


def _back_edge_pair(seed: int, n: int):
    """A dense graph of ``n`` txns with the realtime plane, and its twin
    with one rw edge back to txn 0 from the last txn that txn 0 reaches
    through ww / wr / rw edges: a cycle that needs the rw plane
    (G2-item), with the realtime plane and without it."""
    import numpy as np

    adj = make_graph(random.Random(seed), n, dense=True)
    reach = np.zeros(n, bool)
    reach[0] = True
    frontier = reach.copy()
    deps = adj[0] | adj[1] | adj[2]
    while frontier.any():
        frontier = deps[frontier].any(0) & ~reach
        reach |= frontier
    cyc = adj.copy()
    cyc[2, int(np.flatnonzero(reach)[-1]), 0] = True
    return adj, cyc


def _closure_requests(dev, rec):
    """(t): the closure at the top of the bench, N = 4096, dense with
    the realtime plane, valid and with one back edge closing a G2
    cycle, realtime off, each bit-equal to the host SCC, and the same
    pair at N = CLOSURE_RT_N with realtime on (the realtime plane's
    dense host SCCs are the slow side); then 8 graphs at N = 1024 in
    one batched call."""
    import numpy as np
    import torch

    from comdb2_tpu_torch.txn import closure_torch as TCL
    from comdb2_tpu_torch.txn.scc import cyclic_layers_host

    n = CLOSURE_N
    t0 = time.perf_counter()
    adj, cyc = _back_edge_pair(4096, n)
    pairs = {False: (adj, cyc),
             True: _back_edge_pair(CLOSURE_RT_N, CLOSURE_RT_N)}
    t_gen = time.perf_counter() - t0
    runs = []
    for realtime in (True, False):
        for label, a in zip(("valid", "back edge"), pairs[realtime]):
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
                         "N": int(a.shape[1]),
                         "equal": same, "calls": TCL.DISPATCHES - d0,
                         "cyclic_per_layer": host.sum(1).tolist(),
                         "wall_s": wall, "host_s": t_host})
            print(f"  t {label} N={a.shape[1]}, realtime {realtime}: "
                  f"closure_diag "
                  f"{'bit-equal' if same else 'DIFFERENT'} to the host SCC, "
                  f"cyclic per layer {host.sum(1).tolist()}; wall "
                  f"{wall * 1e3:.1f} ms (pack, upload, squarings, readback), "
                  f"host SCC {t_host:.2f} s")
            _expect(same and TCL.DISPATCHES - d0 == 1,
                    f"(t) closure_diag differs from the host SCC or took "
                    f"{TCL.DISPATCHES - d0} calls: {runs[-1]}")
    _expect(not runs[0]["cyclic_per_layer"][2]
            and not runs[2]["cyclic_per_layer"][2]
            and runs[1]["cyclic_per_layer"][2] > 0
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
    """(w): the three families at the top rungs (WL_LANES bank lanes,
    WL_GEN_LANES sets and dirty lanes, each batch padded to the top
    rung), valid and with their violation twins; every lane against the host oracle,
    one device call per batch; the device program timed alone."""
    import torch

    from comdb2_tpu_torch import convert
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.checker.wl import batch as WB

    specs = {
        "bank": (lambda: W.bank_batch(1, WL_LANES, n_accounts=8,
                                       n_transfers=512, n_reads=512),
                 "total"),
        "sets": (lambda: (W.sets_batch(2, WL_GEN_LANES, n_adds=8000),
                          None), "lost"),
        "dirty": (lambda: (W.dirty_batch(3, WL_GEN_LANES, n_writes=8000,
                                         n_reads=512, n_nodes=16), None),
                  "dirty"),
    }
    rec["w"] = {}
    for fam, (gen, twin) in specs.items():
        r = rec["w"][fam] = {}
        t0 = time.perf_counter()
        valid_hs, model = gen()
        t_gen = time.perf_counter() - t0
        if fam == "bank":
            _W_BANK.update(hs=valid_hs, model=model)
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
                # the device program alone, at the batch's padded rung
                hs = hs + [hs[0]] * (W.WL_BATCH[-1] - len(hs))
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
    from comdb2_tpu_torch.utils import compile_guard as CG
    from comdb2_tpu_torch.checker.checkers import Linearizable
    from comdb2_tpu_torch.checker.independent import IndependentChecker
    from comdb2_tpu_torch.models.model import cas_register

    t0 = time.perf_counter()
    per, keyed = _i_histories()
    t_gen = time.perf_counter() - t0
    s0 = CG.LAUNCHES["seg_search_stream"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = IndependentChecker(Linearizable(device=dev)).check(
        {}, cas_register(), keyed)
    wall = time.perf_counter() - t0
    stream = CG.LAUNCHES["seg_search_stream"] - s0
    l0 = CG.LAUNCHES["seg_search"]
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
                "comparison_launches": CG.LAUNCHES["seg_search"] - l0,
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


NATIVE_TARGETS = ("libct_sut.so", "sut_node")


def _start_native_build():
    """Start building ``native/build/libct_sut.so`` (the C++ EDN loader
    behind ``ops.native_loader``) and ``native/build/sut_node`` (the
    replicated SUT node of path 9) when one is missing and ``cmake`` is
    on the PATH; returns the process or None. Its log goes to
    ``native/build/build.log``."""
    import shutil

    build_dir = os.path.join(HERE, "native", "build")
    if (all(os.path.exists(os.path.join(build_dir, f))
            for f in NATIVE_TARGETS)
            or not os.path.isdir(os.path.join(HERE, "native"))
            or shutil.which("cmake") is None):
        return None
    os.makedirs(build_dir, exist_ok=True)
    log = open(os.path.join(build_dir, "build.log"), "w")
    cmd = ("cmake -S native -B native/build -DCMAKE_BUILD_TYPE=Release && "
           "cmake --build native/build --target ct_sut sut_node -j 8")
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
    from comdb2_tpu_torch.utils import compile_guard as CG
    from comdb2_tpu_torch.report.shrink_svg import render_minimal
    from comdb2_tpu_torch.shrink import minimize

    rec[label] = {}
    for kind in ("stale-read", "lost-update"):
        t0 = time.perf_counter()
        h, truth = register_seed(n_events, kind)
        t_gen = time.perf_counter() - t0
        s0 = CG.LAUNCHES["seg_search_stream"]
        r, wall, spans, card = _traced_run(
            lambda: minimize(h, checker="linear", model="cas-register",
                             F=SHRINK_F, engine="auto", device=dev),
            [_CardTimer(SK, "seg_search_stream")])
        launches = CG.LAUNCHES["seg_search_stream"] - s0
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


# --- path 7: the verifier service -------------------------------------------

SV_REQUESTS = 256         # (sv1): check requests in the burst
SV_CONNS = 64             # (sv1): client connections sending them
SV_CAP = 64               # (sv1): the daemon's --batch-cap
SV_CORE = 64              # (sv3): histories through the in-process core
SV_WL = 64                # (sv2): bank lanes (and as many total twins)
SV_APPENDS = 64           # (sv2): (a)'s appends of STREAM_DELTA events
SV_READY_S = 300.0        # the daemon's ready line (it builds and primes)

#: (w)'s bank lanes, kept for (sv2)
_W_BANK: dict = {}


def _start_daemon(*args, env=None):
    """``python -m comdb2_tpu_torch.service`` from this checkout; returns
    ``(proc, ready)``, ``ready`` None when it exited without a ready
    line. The caller stops and reaps ``proc`` (``_stop_daemon``)."""
    import select

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    err = open(os.path.join(HERE, "chiprun_out", "service_daemon.err"),
               "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "comdb2_tpu_torch.service", "--port", "0",
         *args], cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True,
        env=env)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], SV_READY_S)
    line = proc.stdout.readline() if ready else ""
    if not line.strip():
        return proc, None
    return proc, json.loads(line)


def _stop_daemon(proc, port=None):
    """Ask the daemon to shut down, then wait on it (terminate, kill)."""
    if port is not None and proc.poll() is None:
        try:
            from comdb2_tpu_torch.service.client import ServiceClient

            with ServiceClient("127.0.0.1", port, retries=0) as c:
                c.shutdown()
        except (OSError, ValueError):
            pass
    for stop in (None, proc.terminate, proc.kill):
        if stop is not None and proc.poll() is None:
            stop()
        try:
            proc.wait(timeout=60)
            break
        except subprocess.TimeoutExpired:
            continue
    if proc.stdout is not None:
        proc.stdout.close()


def _scrape(port):
    """(kernel launches by kernel, nvcc builds, status) from the
    daemon's ``metrics`` and ``status`` verbs."""
    from comdb2_tpu_torch.service.client import ServiceClient

    with ServiceClient("127.0.0.1", port) as c:
        m = c.metrics()["metrics"]
        st = c.status()["status"]
    launches = {s["labels"]["kernel"]: s["value"]
                for s in m["compile_kernel_launches_total"]["series"]}
    builds = m["compile_kernel_builds_total"]["series"][0]["value"]
    return launches, builds, st


def _sv_burst(port, hs, want, rec):
    """(sv1): SV_REQUESTS check requests from SV_CONNS connections at
    once; each reply against the direct ``check_batch`` verdict."""
    import threading

    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.service import protocol
    from comdb2_tpu_torch.service.client import ServiceClient

    texts = [history_to_edn(h) for h in hs]
    replies = [None] * len(hs)
    rtt = [0.0] * len(hs)
    errors = []
    barrier = threading.Barrier(SV_CONNS)

    def client(c_i):
        try:
            with ServiceClient("127.0.0.1", port, timeout_s=300.0) as c:
                c.ping()
                barrier.wait(timeout=120)
                for i in range(c_i, len(hs), SV_CONNS):
                    t0 = time.perf_counter()
                    replies[i] = c.check(texts[i], raise_on_error=False)
                    rtt[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:                  # noqa: BLE001
            errors.append(f"connection {c_i}: {type(e).__name__}: {e}")

    l0, b0, st0 = _scrape(port)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SV_CONNS)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    l1, b1, st1 = _scrape(port)
    _expect(not errors and all(r is not None for r in replies),
            f"(sv1) burst failed: {errors[:3]}")
    st_w, fa_w, _ = want
    bad = [i for i, r in enumerate(replies)
           if not r.get("ok")
           or r.get("valid") != protocol.verdict(st_w[i])
           or r.get("op_index") != int(fa_w[i])]
    stages = {s: [r["stages"][s] for r in replies]
              for s in ("queue_wait_ms", "host_pack_ms", "device_ms",
                        "finalize_ms")}
    lat = [r["latency_ms"] for r in replies]
    stage_sum = sum(r["stages"]["device_ms"] / r["batched"]
                    for r in replies)
    busy = st1["kernels"]["card_ms"] - st0["kernels"]["card_ms"]
    d_disp = st1["dispatches"] - st0["dispatches"]
    reasons = {k: st1[f"launch_{k}"] - st0[f"launch_{k}"]
               for k in ("full", "deadline", "idle")}
    launches = {k: l1.get(k, 0) - l0.get(k, 0) for k in l1}
    rec["sv1"] = {
        "requests": len(hs), "connections": SV_CONNS, "wall_s": wall,
        "mismatched": bad, "invalid": sum(r["valid"] is False
                                          for r in replies),
        "latency_ms": {"p50": _pct(lat, 0.5), "p99": _pct(lat, 0.99)},
        "client_rtt_ms": {"p50": _pct(rtt, 0.5), "p99": _pct(rtt, 0.99)},
        "stage_ms": {s: {"p50": _pct(v, 0.5), "p99": _pct(v, 0.99)}
                     for s, v in stages.items()},
        "dispatches": d_disp, "requests_per_dispatch": len(hs) / max(
            d_disp, 1), "launch_reasons": reasons,
        "kernel_launches": launches, "kernel_builds": b1 - b0,
        "ring_polled": st1["ring_polled"] - st0["ring_polled"],
        "card_busy_ms": busy, "card_busy_share": busy / (wall * 1e3),
        "device_stage_sum_over_wall": stage_sum / (wall * 1e3),
        "requests_per_s": len(hs) / wall}
    r = rec["sv1"]
    print(f"  sv1 burst: {len(hs)} check requests from {SV_CONNS} "
          f"connections in {wall:.3f} s ({r['requests_per_s']:.1f} req/s); "
          f"{r['invalid']} INVALID; "
          f"{'every reply equals' if not bad else f'replies {bad[:8]} differ from'} "
          f"the direct check_batch verdict and fail index")
    print(f"  sv1 latency (admission to reply) p50 {r['latency_ms']['p50']:.1f}"
          f" ms, p99 {r['latency_ms']['p99']:.1f} ms; client round trip p50 "
          f"{r['client_rtt_ms']['p50']:.1f} ms, p99 "
          f"{r['client_rtt_ms']['p99']:.1f} ms")
    print("  sv1 stages p50 / p99 (ms): " + "; ".join(
        f"{s.replace('_ms', '')} {v['p50']:.2f} / {v['p99']:.2f}"
        for s, v in r["stage_ms"].items()))
    print(f"  sv1 dispatches {d_disp}, {r['requests_per_dispatch']:.1f} "
          f"requests per dispatch, {r['ring_polled']} of them finished "
          f"when their event polled done; launch reasons {reasons}; kernel "
          f"launches {launches}, nvcc builds {b1 - b0} (the daemon's "
          f"compile-guard counters, scraped)")
    print(f"  sv1 the card busy {busy:.3f} ms of the {wall * 1e3:.1f} ms "
          f"wall, share {r['card_busy_share']:.5f} (the daemon's CUDA "
          f"events around each launch, scraped); device stages summed per "
          f"dispatch over the wall {r['device_stage_sum_over_wall']:.3f} "
          f"(a stage spans launch to observed readback, ring residence "
          f"included, so overlapping stages count twice: not a share)")
    _expect(not bad, f"(sv1) replies differ from the direct call: {bad}")
    _expect(launches.get("seg_search_stream", 0) > 0,
            f"(sv1) the burst launched no stream kernel: {launches}")
    _expect(busy > 0, f"(sv1) the daemon timed no card time: {busy} ms")
    return launches


def _sv_mixed(port, ref, rec):
    """(sv2): a txn request (t2's base with G1c), (w)'s bank lanes and
    their total twins, a stream session of (a)'s first appends, a
    shrink of the stale-read fixture, and (h)'s overflowing lanes as
    check requests, on the same daemon; each reply against the direct
    call."""
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.service import protocol
    from comdb2_tpu_torch.service.client import ServiceClient

    from concurrent.futures import ThreadPoolExecutor

    def check_one(h):
        with ServiceClient("127.0.0.1", port, timeout_s=600.0) as c1:
            return c1.check(history_to_edn(h), raise_on_error=False)

    out = {}
    with ServiceClient("127.0.0.1", port, timeout_s=600.0) as c:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(ref["over_hs"])) as ex:
            got = list(ex.map(check_one, ref["over_hs"]))
        st_o, fa_o, _ = ref["over"]
        bad = [i for i, r in enumerate(got)
               if r.get("valid") != protocol.verdict(st_o[i])
               or r.get("op_index") != int(fa_o[i])]
        out["overflow"] = {"requests": len(got),
                           "wall_s": time.perf_counter() - t0,
                           "valid": [r.get("valid") for r in got],
                           "mismatched": bad}
        _expect(not bad, f"(sv2) overflowing check replies differ from the "
                         f"direct call: {bad}, {out['overflow']}")
        t0 = time.perf_counter()
        r = c.check(history_to_edn(ref["txn_h"]), txn=True,
                    raise_on_error=False)
        want = ref["txn"]
        out["txn"] = {"wall_s": time.perf_counter() - t0,
                      "valid": r.get("valid"),
                      "class": r.get("anomaly_class"),
                      "cycle_len": r.get("cycle_len"),
                      "engine": r.get("engine"), "bucket": r.get("bucket")}
        _expect(r.get("valid") is want["valid?"] is False
                and r.get("anomaly_class") == want["counterexample"][
                    "class"] == "G1c"
                and r.get("cycle_len") == len(want["counterexample"][
                    "cycle"]), f"(sv2) txn reply {r} != direct {want}")
        t0 = time.perf_counter()
        got = [c.check_wl(history_to_edn(h), "bank", wl=ref["bank_model"],
                          raise_on_error=False) for h in ref["bank_hs"]]
        wl_wall = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, ref["bank"]))
               if g.get("valid") != w["valid?"]]
        out["wl"] = {"lanes": len(got), "wall_s": wl_wall,
                     "invalid": sum(g.get("valid") is False for g in got),
                     "engines": sorted({g.get("engine") for g in got}),
                     "mismatched": bad}
        _expect(not bad and out["wl"]["invalid"] == len(got) // 2,
                f"(sv2) bank replies differ from the direct call: {bad}, "
                f"{out['wl']}")
        t0 = time.perf_counter()
        sid = c.stream_open()["session"]
        verdicts = [c.stream_append(sid, history_to_edn(d)).get("valid")
                    for d in ref["deltas"]]
        closed = c.stream_close(sid)
        out["stream"] = {"appends": len(verdicts),
                         "wall_s": time.perf_counter() - t0,
                         "valid": closed.get("valid"),
                         "final_count": closed.get("final_count")}
        _expect(verdicts == ref["stream_verdicts"]
                and closed.get("valid") == ref["stream_close"]["valid"]
                and closed.get("final_count") == ref["stream_close"].get(
                    "final_count"),
                f"(sv2) stream replies differ from the direct session: "
                f"{verdicts[-3:]} {closed}")
        t0 = time.perf_counter()
        sr = c.shrink(ref["shrink_text"], raise_on_error=False)
        want = ref["shrink"]
        out["shrink"] = {"wall_s": time.perf_counter() - t0,
                         "valid": sr.get("valid"),
                         "seed_ops": sr.get("seed_ops"),
                         "minimal_ops": sr.get("minimal_ops"),
                         "rounds": sr.get("rounds")}
        _expect(sr.get("valid") is want.valid is False
                and sr.get("minimal_ops") == want.n_ops
                and sr.get("one_minimal") is True,
                f"(sv2) shrink reply {out['shrink']} != direct "
                f"({want.n_ops} ops)")
    rec["sv2"] = out
    print(f"  sv2 overflow: {len(ref['over_hs'])} 8-process check requests "
          f"past the kernel's 128 configs, sent at once, "
          f"{out['overflow']['wall_s']:.2f} s, verdicts "
          f"{out['overflow']['valid']}")
    print(f"  sv2 txn: {len(ref['txn_h']) // 2} txns + G1c -> "
          f"{out['txn']['class']}, cycle of {out['txn']['cycle_len']}, "
          f"bucket {out['txn']['bucket']}, {out['txn']['wall_s']:.3f} s; "
          f"wl bank: {out['wl']['lanes']} lanes ({out['wl']['invalid']} "
          f"total twins INVALID) in {wl_wall:.2f} s; stream: "
          f"{len(verdicts)} appends of {STREAM_DELTA} events, close "
          f"valid={out['stream']['valid']!r} in "
          f"{out['stream']['wall_s']:.2f} s; shrink: "
          f"{out['shrink']['seed_ops']} -> {out['shrink']['minimal_ops']} "
          f"ops in {out['shrink']['rounds']} rounds, "
          f"{out['shrink']['wall_s']:.2f} s; every reply equals the direct "
          f"call")


def _sv_core(dev, hs, want, rec):
    """(sv3): ``VerifierCore(device="cuda")`` in this process: SV_CORE of
    (sv1)'s histories, one ``tick``; the stream launch it made is
    captured, and group streams of it are held bit-equal to the plain
    version (and to the same groups within the launch)."""
    import torch

    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.utils import compile_guard as CG
    from comdb2_tpu_torch.obs import trace as obs
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.service import VerifierCore, protocol

    real = SK.seg_search_stream
    captured = []

    events = []

    def capturing(seg, stride, table, spec, n_hist, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real(seg, stride, table, spec, n_hist, **kw)
        e1.record()
        events.append((e0, e1))
        captured.append((seg, stride, table, spec, n_hist, res))
        return res

    core = VerifierCore(device=dev, batch_cap=SV_CORE)
    SK.seg_search_stream = capturing
    try:
        for i in range(SV_CORE):
            core.submit({"op": "check", "id": i,
                         "history": history_to_edn(hs[i])},
                        obs.monotonic())
        t0 = time.perf_counter()
        done = core.tick()
        wall = time.perf_counter() - t0
    finally:
        SK.seg_search_stream = real
    replies = {r["id"]: r for _, r in done}
    torch.cuda.synchronize()
    card_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    # the stage returns while its launch still runs: no readback in it
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.models.model import cas_register

    probe = TB.pack_batch(hs[:SV_CORE], cas_register())
    TB._stream_segments(probe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = TB.check_batch_async(probe, F=1024, device=dev)
    stage_ms = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream(dev).query()
    t0 = time.perf_counter()
    fin()
    wait_ms = (time.perf_counter() - t0) * 1e3
    print(f"  sv3 check_batch_async on {SV_CORE} cached histories: stage "
          f"{stage_ms:.2f} ms, the card {'still busy' if busy else 'IDLE'} "
          f"when it returned; finalize waited {wait_ms:.2f} ms")
    _expect(busy or dev.type != "cuda",
            "(sv3) check_batch_async's stage waited for its launch")
    st_w, fa_w, _ = want
    bad = [i for i in range(SV_CORE)
           if replies[i].get("valid") != protocol.verdict(st_w[i])
           or replies[i].get("op_index") != int(fa_w[i])]
    _expect(not bad and captured and core.m["engine_errors"] == 0,
            f"(sv3) core replies differ: {bad}, {len(captured)} launches, "
            f"{core.m['engine_errors']} engine errors")
    # the plain version on two group streams of the first captured
    # launch: the longest, and the first whose results hold an INVALID
    # history
    seg, stride, table, spec, n_hist, res = captured[0]
    rows = (seg[:, :, 0] != -1).sum(1)
    inv = (res[:, :, 0] == SK.INVALID).any(1).nonzero().flatten().tolist()
    pick = sorted({int(rows.argmax())} | set(inv[:1]))
    ws0 = torch.from_numpy(SK.initial_frontier(spec)).to(dev)
    st0 = torch.from_numpy(SK._init_stat()).to(dev)
    t0 = time.perf_counter()
    err = 0
    # the comparison launches below are not counted
    counted = CG.LAUNCHES["seg_search_stream"]
    for g in pick:
        want_g = torch.zeros_like(res[g])
        SK.seg_search_reference(seg[g], 0, stride, ws0, st0, table, spec,
                                results=want_g)
        alone = real(seg[g:g + 1].contiguous(), stride, table, spec,
                     n_hist)[0]
        err = max(err, int((res[g].long() - want_g.long()).abs().max()),
                  int((alone.long() - want_g.long()).abs().max()))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    CG.LAUNCHES["seg_search_stream"] = counted
    rec["sv3"] = {"requests": SV_CORE, "tick_s": wall,
                  "launches": len(captured), "card_ms": card_ms,
                  "card_share": card_ms / (wall * 1e3),
                  "groups": int(seg.shape[0]), "rows": int(seg.shape[1]),
                  "checked_groups": pick, "max_abs_err": err,
                  "plain_ms": plain_ms,
                  "stage_ms": core.status()["stage_ms"],
                  "async": {"stage_ms": stage_ms, "busy_after_stage": busy,
                            "finalize_wait_ms": wait_ms}}
    print(f"  sv3 VerifierCore(device='cuda'): {SV_CORE} requests, one tick "
          f"{wall:.3f} s, the card {card_ms:.3f} ms of it (CUDA events "
          f"around the launches: {card_ms / (wall * 1e3):.4f} of the "
          f"tick), {len(captured)} seg_search[stream] launch "
          f"({seg.shape[0]} streams x {seg.shape[1]} rows); group streams "
          f"{pick} {'bit-equal' if err == 0 else f'max diff {err}'} to "
          f"seg_search_reference and to themselves launched alone (plain "
          f"version {plain_ms:.1f} ms)")
    _expect(err == 0, "(sv3) the service's stream launch differs from its "
                      "plain version")
    return err, len(captured)


def _sv_mesh(dev, batch, want, rec):
    """(sv4): (i)'s keys through ``check_batch(mesh=make_mesh(1))``, equal
    to the run without a mesh; D = 2 where the host has two cards."""
    import numpy as np
    import torch

    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.service.sharding import make_mesh

    out = {}
    for D in (1, 2):
        if D > torch.cuda.device_count():
            print(f"  sv4 mesh D>1: not run on the card "
                  f"({torch.cuda.device_count()} device)")
            out[f"D{D}"] = "not run (one device)"
            continue
        info: dict = {}
        t0 = time.perf_counter()
        got = TB.check_batch(batch, F=1024, mesh=make_mesh(D, dev.type),
                             info=info)
        wall = time.perf_counter() - t0
        same = all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
        out[f"D{D}"] = {"engine": info["engine"], "wall_s": wall,
                        "equal": same, "batch": info["batch"]}
        print(f"  sv4 check_batch(mesh=make_mesh({D})): {len(batch)} keys, "
              f"engine {info['engine']}, {wall:.3f} s; verdicts and fail "
              f"indices {'equal' if same else 'DIFFERENT from'} the run "
              f"without a mesh")
        _expect(same, f"(sv4) mesh D={D} differs from the run without one")
    rec["sv4"] = out


def _sv_filetest(port, h_e, rec):
    """(sv5): ``filetest --service`` against the daemon."""
    import contextlib
    import io

    from comdb2_tpu_torch import filetest
    from comdb2_tpu_torch.ops.history import history_to_edn

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sv5_")
    edn_path = os.path.join(tmp.name, "e.edn")
    with open(edn_path, "w") as fh:
        fh.write(history_to_edn(h_e))
    out = {}
    for label, args, want in (
            ("e", [edn_path], 1),
            ("clean", [os.path.join(HERE, "tests", "fixtures", "txn",
                                    "clean.edn"), "--checker", "txn"], 0)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = filetest.main([*args, "--service", f"127.0.0.1:{port}"])
        out[label] = rc
        _expect(rc == want, f"(sv5) filetest --service on {label} exited "
                            f"{rc}, want {want}")
    tmp.cleanup()
    rec["sv5"] = out
    print(f"  sv5 filetest --service: (e) exits {out['e']}, "
          f"txn/clean.edn exits {out['clean']}")


def _sv_no_fallback(rec):
    """(sv6): a daemon asked for the card on a host that shows none
    exits non-zero before any ready line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc, ready = _start_daemon("--backend", "cuda", env=env)
    try:
        proc.wait(timeout=120)
    finally:
        _stop_daemon(proc)
    rec["sv6"] = {"ready": ready, "returncode": proc.returncode}
    print(f"  sv6 --backend cuda with CUDA_VISIBLE_DEVICES='': "
          f"{'no ready line' if ready is None else 'READY'}, exit code "
          f"{proc.returncode}")
    _expect(ready is None and proc.returncode not in (0, None),
            f"(sv6) the card-less daemon did not fail at startup: "
            f"{rec['sv6']}")


def _sv_references(dev, h_a):
    """The direct calls every (sv) reply is held against, made before the
    path's counted run: check_batch on (i)'s keys, check_txn on (t2)'s
    base with G1c, check_wl_batch on (w)'s bank lanes and twins, a
    StreamSession over (a)'s first appends, minimize on the stale-read
    fixture."""
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.native_loader import parse_history_fast
    from comdb2_tpu_torch.ops.synth import (list_append_history,
                                             register_history,
                                             txn_anomaly_history)
    from comdb2_tpu_torch.shrink import minimize
    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.txn import check_txn

    ref = {}
    t0 = time.perf_counter()
    ref["hs"], _ = _i_histories()
    ref["batch"] = TB.pack_batch(ref["hs"], cas_register())
    ref["want"] = TB.check_batch(ref["batch"], F=1024, device=dev)
    # (h)'s eight 8-process lanes: they overflow the kernel's 128
    # configs and escalate through the keys engine (the pair sort)
    ref["over_hs"] = [register_history(
        random.Random(seed), n_procs=8, n_events=400, values=5,
        p_info=0.0, max_pending=8) for seed in (0, 1, 3, 4, 5, 7, 8, 10)]
    ref["over"] = TB.check_batch(TB.pack_batch(ref["over_hs"],
                                               cas_register()),
                                 F=1024, device=dev)
    base = list_append_history(random.Random(2048), n_procs=16,
                               n_txns=TXN_COUNT, n_keys=64, max_micro=4)
    ref["txn_h"] = base + _fresh(txn_anomaly_history("g1c"), 10_000)
    ref["txn"] = check_txn(ref["txn_h"], device=dev)
    if _W_BANK:
        valid = _W_BANK["hs"][:SV_WL]
        model = _W_BANK["model"]
    else:
        valid, model = W.bank_batch(1, SV_WL, n_accounts=8,
                                    n_transfers=512, n_reads=512)
    ref["bank_hs"] = list(valid) + _plant("bank", valid)
    ref["bank_model"] = model
    ref["bank"] = W.check_wl_batch(ref["bank_hs"], "bank", model,
                                   device=dev)
    ref["deltas"] = [h_a[i:i + STREAM_DELTA] for i in
                     range(0, SV_APPENDS * STREAM_DELTA, STREAM_DELTA)]
    s = StreamSession("cas-register", device=dev)
    ref["stream_verdicts"] = [s.append(d)["valid"] for d in ref["deltas"]]
    ref["stream_close"] = s.close()
    with open(os.path.join(HERE, "tests", "fixtures", "shrink",
                           "stale_read.edn")) as fh:
        ref["shrink_text"] = fh.read()
    ref["shrink"] = minimize(parse_history_fast(ref["shrink_text"]),
                             model="cas-register", F=1024, device=dev)
    print(f"  (direct calls for the comparisons: "
          f"{time.perf_counter() - t0:.1f} s)")
    return ref


def _service_path(dev, h_a, h_e, zero_counts, counts):
    """Path 7: the daemon on the card, (sv1)-(sv6). Returns ``(rec,
    launches)``: the path's counts, this process's plus the daemon's
    (scraped from its compile-guard counters over the path)."""
    ref = _sv_references(dev, h_a)
    rec: dict = {}
    zero_counts()
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    proc, ready = _start_daemon("--backend", "cuda", "--batch-cap",
                                str(SV_CAP))
    port = None if ready is None else ready["port"]
    try:
        _expect(ready is not None and ready["backend"] == dev.type,
                f"the daemon did not start on the card: {ready}")
        rec["ready_s"] = time.perf_counter() - t0
        rec["ready"] = ready
        print(f"  daemon ready in {rec['ready_s']:.1f} s on "
              f"{ready['device']}, {ready['primed']} priming dispatches")
        l0, _, _ = _scrape(port)
        _sv_burst(port, ref["hs"], ref["want"], rec)
        _sv_mixed(port, ref, rec)
        _sv_filetest(port, h_e, rec)
        l1, b1, st = _scrape(port)
        rec["daemon_status"] = st
        _expect(st["engine_errors"] == 0,
                f"the daemon answered {st['engine_errors']} engine errors")
    finally:
        _stop_daemon(proc, port)
    rec["daemon_exit"] = proc.returncode
    _sv_core(dev, ref["hs"], ref["want"], rec)
    _sv_mesh(dev, ref["batch"], ref["want"], rec)
    here = counts()
    daemon = {k: l1.get(k, 0) - l0.get(k, 0) for k in l1}
    launches = dict(here)
    for name, key in (("seg_search", "seg_search"),
                      ("seg_search[stream]", "seg_search_stream"),
                      ("pair_sort", "pair_sort")):
        launches[name] = here[name] + daemon.get(key, 0)
    rec["launches"] = {"daemon": daemon, "this_process": here}
    _sv_no_fallback(rec)
    rec["wall_s"] = time.perf_counter() - t_path
    return rec, launches


HARNESS_LIMIT_S = 10.0    # (x1)-(x4): the reference register test's limit
X3_CLIENTS, X3_PER_KEY, X3_GROUP = 100, 200, 5    # (x3): jepsen.independent
X2_CHAOS = {"chaos_unknown": 0.01, "chaos_fail": 0.05, "seed": 2026}
X3_PLANT = (3, 99)        # (x3): the key, and a value no write puts (0-4)
# torch threads of path 8's plain re-checks: with more, a re-check's
# threads wait on each other when the host's cores are busy
# (scripts/torch_recheck_threads.py)
RECHECK_THREADS = 2


class _TimedChecker:
    """A test's checker with its wall clock kept: ``core.run``'s check
    (``check_safe``) runs through it, so the run's wall splits into the
    harness (generation and the SUT) and the check."""

    def __init__(self, inner, sync):
        self.inner = inner
        self.sync = sync
        self.wall_s = None

    def check(self, test, model, history, opts=None):
        t0 = time.perf_counter()
        try:
            return self.inner.check(test, model, history, opts)
        finally:
            self.sync()
            self.wall_s = time.perf_counter() - t0


class _StaleRead:
    """(x4): one stale read in (x1)'s run. A gate around the test's
    generator picks a read once ``after`` ops were drawn and holds it
    back until every other worker has finished its op and waits at the
    gate; the client wrapper then answers that read with the latest value
    an earlier read returned that differs from the register's current
    one (a value the register held before), and the others draw again
    once the reader does. No other call is open while that read is, so
    no linearization explains it. If the others do not come to the gate
    within ``hold_s`` (a phase barrier), the gate lets the read through
    unchanged and waits for a later one."""

    def __init__(self, concurrency, after=100, hold_s=2.0):
        import threading

        self.cv = threading.Condition()
        self.concurrency = concurrency
        self.after = after
        self.hold_s = hold_s
        self.draws = 0
        self.reader = None        # the held read's worker thread
        self.state = "armed"      # -> "holding" -> "reading" -> "done"
        self.idle = set()         # other worker threads at the gate or gone
        self.seen = []            # values that ok reads returned
        self.lie = None           # {process, stale, current}

    def generator(self, inner):
        from comdb2_tpu_torch.harness import generator as G

        gate = self

        class Gate(G.Generator):
            def op(self, test, process):
                return gate.draw(inner, test, process)
        return Gate()

    def draw(self, inner, test, process):
        import threading

        from comdb2_tpu_torch.harness import generator as G

        if process == G.NEMESIS:
            return G.op(inner, test, process)
        me = threading.get_ident()
        with self.cv:
            if me == self.reader and self.state == "reading":
                self.state = "done"
                self.cv.notify_all()
            while self.state in ("holding", "reading") and me != self.reader:
                self.idle.add(me)
                self.cv.notify_all()
                self.cv.wait()
            self.idle.discard(me)
        o = G.op(inner, test, process)
        with self.cv:
            if o is None:
                self.idle.add(me)
                self.cv.notify_all()
                return None
            self.draws += 1
            if self.state == "armed" and self.draws >= self.after \
                    and o.get("f") == "read":
                self.state, self.reader = "holding", me
                deadline = time.monotonic() + self.hold_s
                while len(self.idle) < self.concurrency - 1 \
                        and time.monotonic() < deadline:
                    self.cv.wait(0.05)
                self.state = ("reading" if len(self.idle)
                              >= self.concurrency - 1 else "armed")
                if self.state == "armed":
                    self.reader = None
                    self.cv.notify_all()
        return o

    def client(self, inner):
        import threading

        from comdb2_tpu_torch.harness.client import Client
        from comdb2_tpu_torch.ops.kv import tuple_

        gate = self

        class StaleRead(Client):
            def __init__(self, c):
                self.c = c

            def setup(self, test, node):
                return StaleRead(self.c.setup(test, node))

            def invoke(self, test, op):
                if op["f"] == "read" and gate.state == "reading" \
                        and gate.reader == threading.get_ident() \
                        and gate.lie is None:
                    k = op["value"][0]
                    rows = self.c.conn.select("register",
                                              lambda r: r["id"] == k)
                    cur = rows[0]["val"] if rows else None
                    stale = next((v for v in reversed(gate.seen)
                                  if v is not None and v != cur), None)
                    gate.lie = {"process": op["process"], "stale": stale,
                                "current": cur}
                    if stale is not None:
                        return {**op, "type": "ok",
                                "value": tuple_(k, stale)}
                out = self.c.invoke(test, op)
                if op["f"] == "read" and out["type"] == "ok":
                    with gate.cv:
                        gate.seen.append(out["value"][1])
                return out

            def teardown(self, test):
                self.c.teardown(test)
        return StaleRead(inner)


def _lossy_connect():
    """(x5): a ``MemConn`` whose every 5th write transaction is
    acknowledged but loses its buffered writes at commit."""
    from comdb2_tpu_torch.workloads.sqlish import MemConn, MemDB

    db = MemDB()
    db.counter = 0

    class LossyConn(MemConn):
        def transaction(self):
            ctx = super().transaction()
            conn_db = self.db

            class MaybeDrop:
                def __enter__(s):
                    s.t = ctx.__enter__()
                    return s.t

                def __exit__(s, *a):
                    if a[0] is None and s.t.writes:
                        conn_db.counter += 1
                        if conn_db.counter % 5 == 0:
                            s.t.writes.clear()
                    return ctx.__exit__(*a)
            return MaybeDrop()
    return lambda: LossyConn(db)


def _broken_g2_client():
    """(x5): predicate reads that miss concurrent inserts, so both of a
    key's G2 inserts commit."""
    from comdb2_tpu_torch.harness.client import Client

    class BrokenG2(Client):
        def invoke(self, test, op):
            return {**op, "type": "ok"}
    return BrokenG2()


def _x3_generator(limit_s):
    """(x3): ``jepsen.independent``'s shape — ``concurrent_generator(5,
    itertools.count(), ...)``, each key ``X3_PER_KEY`` ops of [w cas cas
    r] with no stagger, for ``limit_s`` seconds."""
    import itertools

    from comdb2_tpu_torch.harness import generator as G
    from comdb2_tpu_torch.harness import independent_gen as IG

    def w(test=None, process=None):
        return {"type": "invoke", "f": "write",
                "value": random.randrange(5)}

    def cas(test=None, process=None):
        return {"type": "invoke", "f": "cas",
                "value": (random.randrange(5), random.randrange(5))}

    def r(test=None, process=None):
        return {"type": "invoke", "f": "read", "value": None}

    return G.time_limit(limit_s, G.clients(IG.concurrent_generator(
        X3_GROUP, itertools.count(),
        lambda k: G.limit(X3_PER_KEY, G.mix([w, cas, cas, r])))))


def _lin_view(results):
    """The linearizable part of a register test's results: its verdict,
    its failing keys and each key's (verdict, fail index)."""
    lin = results["linearizable"]
    return {"valid?": results["valid?"], "lin": lin["valid?"],
            "failures": lin["failures"],
            "keys": {k: (v["valid?"], v.get("op-index"))
                     for k, v in lin["results"].items()}}


def _ladder(results):
    """Each key of a register test's results that was checked alone:
    its engine, the frontier capacity its answer took (the seg2 ladder
    re-runs the history from the start at each rung it climbs) and the
    analysis's seconds."""
    return {k: [v.get("engine"), v.get("frontier_capacity"),
                round(v.get("time_s") or 0.0, 3)]
            for k, v in results["linearizable"]["results"].items()
            if v.get("backend") != "device-batch"}


def _has_error(x) -> bool:
    if isinstance(x, dict):
        return "error" in x or any(_has_error(v) for v in x.values())
    return False


def _key_answers(results, history):
    """Per key of a register test's linearizable results: the engine of
    its answer and its effective slots (the analysis's own where a key
    was checked alone; for a key answered by the batch launch, the
    stream kernel and the slots its history renames to)."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker.independent import subhistories
    from comdb2_tpu_torch.ops.packed import pack_history

    lin = results["linearizable"]["results"]
    batch = [k for k, v in lin.items() if v.get("backend") == "device-batch"]
    subs = ({k: v for k, v in subhistories(list(lin), history).items()
             if k in batch} if batch else {})
    engines, slots = {}, {}
    for k, v in lin.items():
        if k in subs:
            eng = "seg_search[stream]"
            _, p = LT.remap_slots(LT.make_segments(pack_history(subs[k])))
        else:
            eng = v.get("engine", v.get("backend"))
            p = v.get("effective_slots")
        engines[eng] = engines.get(eng, 0) + 1
        slots[p] = slots.get(p, 0) + 1
    return engines, slots


@contextlib.contextmanager
def _torch_threads(n):
    """Run the block at ``n`` torch threads."""
    import torch

    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _planted_read(inner, key, value):
    """(x3): a client wrapper that answers the first read of ``key``
    with ``value``, which no write puts, so that key's history has no
    linearization; ``planted["op"]`` is the completion it returned."""
    import threading

    from comdb2_tpu_torch.harness.client import Client
    from comdb2_tpu_torch.ops.kv import tuple_

    planted = {"op": None}
    lock = threading.Lock()

    class PlantedRead(Client):
        def __init__(self, c):
            self.c = c

        def setup(self, test, node):
            return PlantedRead(self.c.setup(test, node))

        def invoke(self, test, op):
            if op["f"] == "read" and op["value"][0] == key:
                with lock:
                    if planted["op"] is None:
                        planted["op"] = {**op, "type": "ok",
                                         "value": tuple_(key, value)}
                        return planted["op"]
            return self.c.invoke(test, op)

        def teardown(self, test):
            self.c.teardown(test)
    return PlantedRead(inner), planted


class _LaunchLog:
    """Path 8's segment-search launches: while installed, every launch
    of either mode (``seg_kernel._launch``) is logged under the run that
    made it, with copies of its inputs taken before it and of its
    outputs after it (``(ws_out, stat_out)``, or the stream mode's
    ``results``), for :func:`_hold_launches`."""

    def __init__(self):
        self.run = None
        self.launches = []        # (run, inputs, outputs) per launch
        self._real = None

    def install(self):
        from comdb2_tpu_torch.checker import seg_kernel as SK

        real = self._real = SK._launch
        log = self

        def logged(seg, off, stride, ws, stat, table, spec, results=None,
                   **kw):
            inputs = (seg.clone(), off, stride, ws.clone(), stat.clone(),
                      table.clone(), spec)
            ws_out, stat_out = real(seg, off, stride, ws, stat, table, spec,
                                    results=results, **kw)
            log.launches.append((log.run, inputs, (
                (ws_out.clone(), stat_out.clone()) if results is None
                else results.clone())))
            return ws_out, stat_out
        SK._launch = logged

    def uninstall(self):
        from comdb2_tpu_torch.checker import seg_kernel as SK

        SK._launch = self._real


def _hold_launches(log, path="path 8"):
    """A path's launches against the plain version: each single-history
    launch bit-equal (status, fail, n, frontier) to
    ``seg_search_reference`` on the same card tensors; each stream
    launch's longest group and its groups with an INVALID lane on the
    same card tensors, and every group's (status, fail, n) on CPU copies
    of them. Returns (max abs error, per-run record, plain ms)."""
    import torch

    from comdb2_tpu_torch.checker import seg_kernel as SK

    err, held, t0 = 0, {}, time.perf_counter()
    for run, (seg, off, stride, ws, stat, table, spec), out in log.launches:
        r = held.setdefault(run, {"single": [], "stream": []})
        if not isinstance(out, torch.Tensor):
            ws_k, st_k = out
            status, fail, n, ws_p = SK.seg_search_reference(
                seg, off, stride, ws, stat, table, spec)
            st_p = [status, fail, n, int(stat[3])]
            _expect(torch.equal(ws_p, ws_k) and st_p == st_k.tolist(),
                    f"({run}) a single-history launch: kernel "
                    f"{st_k.tolist()} vs plain {st_p}, frontier "
                    f"{'equal' if torch.equal(ws_p, ws_k) else 'differs'}")
            r["single"].append({"rows": int(seg.shape[0]), "off": off,
                                "status": status, "fail": fail, "n": n})
            continue
        rows = (seg[:, :, 0] != -1).sum(1)
        lanes = (out[:, :, 0] == SK.INVALID).nonzero().tolist()
        on_card = sorted({int(rows.argmax())} | {g for g, _ in lanes})
        for g in on_card:
            want = torch.zeros_like(out[g])
            SK.seg_search_reference(seg[g], 0, stride, ws[g], stat[g],
                                    table, spec, results=want)
            err = max(err, int((out[g].long() - want.long()).abs().max()))
        seg_c, ws_c, st_c, tab_c = (x.cpu() for x in (seg, ws, stat, table))
        want = torch.zeros(out.shape, dtype=torch.int32)
        with _torch_threads(RECHECK_THREADS):
            for g in range(seg.shape[0]):
                SK.seg_search_reference(seg_c[g], 0, stride, ws_c[g],
                                        st_c[g], tab_c, spec,
                                        results=want[g])
        err = max(err, int((out.cpu().long() - want.long()).abs().max()))
        # an INVALID lane's fail, less its history's first stream row
        # (the row after its RESET): its segment in the history alone
        resets = [(seg[g, :, 0] == SK.RESET).nonzero().flatten().tolist()
                  for g, _ in lanes]
        r["stream"].append({
            "groups": int(seg.shape[0]), "rows": int(seg.shape[1]),
            "on_card": on_card,
            "invalid": [[g, h, *out[g, h].tolist(),
                         int(out[g, h, 1]) - rs[h] - 1]
                        for (g, h), rs in zip(lanes, resets)]})
    _expect(err == 0, f"{path}'s launches differ from the plain version: "
                      f"max diff {err}, {held}")
    return err, held, (time.perf_counter() - t0) * 1e3


def _register_view(results):
    """:func:`_lin_view` through JSON, as a child process reports it."""
    return json.loads(json.dumps(_lin_view(results)))


def _recheck_saved(store_root, name, start_time):
    """In a child process: load a register run the store saved and
    check its history with ``register_tester``'s checkers built at
    ``device="cpu"``; returns the view, whether a result holds an
    ``error``, the keys checked alone and the wall."""
    import torch

    from comdb2_tpu_torch.harness import store
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.kv import wrap_keyed_history
    from comdb2_tpu_torch.workloads import comdb2 as W

    torch.set_num_threads(RECHECK_THREADS)
    t0 = time.perf_counter()
    saved = store.load(name, start_time, store_root)
    h = wrap_keyed_history(saved["history"])
    res = W.register_tester(device="cpu")["checker"].check(
        {"name": name, "dir": os.path.join(store_root, "cpu-recheck")},
        cas_register(), h)
    return {"view": _register_view(res), "error": _has_error(res),
            "ladder": _ladder(res), "events": len(h),
            "wall_s": time.perf_counter() - t0}


class _DeferredRecheck:
    """(x2)'s plain-version re-check in a child process, from the
    history the run's store saved: it overlaps the rest of the script,
    and :meth:`finish` waits for it and compares. Its time depends on
    the history, through the rung of the seg2 ladder it climbs to (the
    card's rung too, up to 65536): 17-346 s on an H100 host's CPU. The
    child is killed if the script exits first."""

    def __init__(self, name, out, r):
        import atexit

        self.name, self.r = name, r
        self.want = _register_view(out["results"])
        self.store = out["store-root"]
        code = ("import json, sys; sys.path.insert(0, {here!r}); "
                "import chip_smoke as CS; print(json.dumps("
                "CS._recheck_saved({root!r}, {name!r}, {ts!r})))"
                ).format(here=HERE, root=self.store, name=out["name"],
                         ts=out["start-time"])
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", code],
                                     cwd=HERE, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        atexit.register(self.kill)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, timeout_s=900.0):
        import shutil

        try:
            out, err = self.proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise _Failed(f"({self.name}) the plain versions' re-check "
                          f"took more than {timeout_s} s")
        shutil.rmtree(self.store, ignore_errors=True)
        _expect(self.proc.returncode == 0,
                f"({self.name}) the re-check's child failed: {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        r = self.r
        r["cpu_recheck_s"] = got["wall_s"]
        r["cpu_recheck_overlapped_s"] = time.perf_counter() - self.t0
        r["cpu_ladder"] = got["ladder"]
        r["equal_to_cpu"] = got["view"] == self.want \
            and got["events"] == r["events"]
        r["error"] = r["error"] or got["error"]
        print(f"  {self.name}: the plain versions' re-check of the saved "
              f"history (a child process, {RECHECK_THREADS} torch threads) "
              f"{got['wall_s']:.2f} s, waited "
              f"{r['cpu_recheck_overlapped_s']:.2f} s after its start, "
              f"{'equal' if r['equal_to_cpu'] else 'DIFFERENT'}; keys "
              f"checked alone (engine, capacity, s): {got['ladder']}")
        _expect(r["equal_to_cpu"] and not r["error"],
                f"({self.name}) differs from the plain versions' re-check "
                f"or holds an error: {got} against {self.want}")


def _harness_run(name, t, dev, rec, recheck, capture=None, defer=False,
                 keep_nodes=False):
    """Run test map ``t`` through ``core.run`` on ``dev`` (nodes = []
    unless ``keep_nodes``, a store under a temporary directory), then
    its recorded history through ``recheck``, the same checkers built at
    ``device="cpu"``, at ``RECHECK_THREADS`` torch threads — or, with
    ``defer``, in a child process from the saved history (returned as a
    :class:`_DeferredRecheck`). Records walls, launches, card ms, sizes
    and the comparison."""
    import shutil

    import torch

    from comdb2_tpu_torch.harness import core
    from comdb2_tpu_torch.utils import compile_guard as CG

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    store = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    if not keep_nodes:
        t["nodes"] = []
    t["store-root"] = store
    timed = _TimedChecker(t["checker"], sync)
    t["checker"] = timed
    l0 = dict(CG.LAUNCHES)
    ms0 = CG.card_ms()
    t0 = time.perf_counter()
    out = core.run(t)
    wall = time.perf_counter() - t0
    ms = CG.card_ms() - ms0
    launches = {k: CG.LAUNCHES[k] - l0[k] for k in l0}
    res, h = out["results"], out["history"]
    r = {"valid": res["valid?"], "events": len(h),
         "invocations": sum(op.type == "invoke" for op in h),
         "infos": sum(op.type == "info" and op.process != "nemesis"
                      for op in h),
         "fails": sum(op.type == "fail" for op in h),
         "processes": len({op.process for op in h}),
         "run_wall_s": wall, "check_wall_s": timed.wall_s,
         "harness_wall_s": wall - timed.wall_s, "card_ms": ms,
         "launches": launches, "error": _has_error(res)}
    if "linearizable" in res:
        r["keys"] = len(res["linearizable"]["results"])
        r["failures"] = res["linearizable"]["failures"]
        r["engines"], r["slots"] = _key_answers(res, h)
    if capture is not None:
        capture(out, r)
    rec[name] = r
    print(f"  {name}: {t['name']} valid={res['valid?']!r}, "
          f"{r['events']} events ({r['invocations']} invocations, "
          f"{r['infos']} info, {r['fails']} fail, {r['processes']} "
          f"processes)"
          + (f", {r['keys']} keys, engines {r['engines']}, effective "
             f"slots {r['slots']}" if "keys" in r else "")
          + f"; harness {r['harness_wall_s']:.2f} s, check "
          f"{r['check_wall_s']:.2f} s, card {ms:.3f} ms in launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if "linearizable" in res:
        r["ladder"] = _ladder(res)
        # where each info op pends from, as a share of the history
        r["info_at"] = [round(i / len(h), 3) for i, op in enumerate(h)
                        if op.type == "info" and op.process != "nemesis"]
    if defer:
        return _DeferredRecheck(name, out, r)
    t0 = time.perf_counter()
    with _torch_threads(RECHECK_THREADS):
        again = recheck().check(
            {"name": t["name"], "dir": os.path.join(store, "cpu-recheck")},
            t.get("model"), h)
    r["cpu_recheck_s"] = time.perf_counter() - t0
    r["error"] = r["error"] or _has_error(again)
    r["equal_to_cpu"] = (_lin_view(res) == _lin_view(again)
                         if "linearizable" in res else res == again)
    shutil.rmtree(store, ignore_errors=True)
    if "linearizable" in res:
        r["cpu_ladder"] = _ladder(again)
    print(f"  {name}: the plain versions' re-check ({RECHECK_THREADS} "
          f"torch threads) {r['cpu_recheck_s']:.2f} s, "
          f"{'equal' if r['equal_to_cpu'] else 'DIFFERENT'}"
          + (f"; keys checked alone (engine, capacity, s): card "
             f"{r['ladder']}, plain {r['cpu_ladder']}; info ops at "
             f"{r['info_at']} of the history" if r.get("ladder") else ""))
    return None


def _harness_runs(device, rec, log=None, limit_s=HARNESS_LIMIT_S):
    """(x1)-(x5) on ``device`` (``None``, the testers' default, is the
    card), each history re-checked at ``device="cpu"``, (x2)'s in a
    child process: returns its :class:`_DeferredRecheck`; ``log``, a
    :class:`_LaunchLog`, is told which run is on."""
    import shutil

    import torch

    from comdb2_tpu_torch.workloads import comdb2 as W
    from comdb2_tpu_torch.workloads.sqlish import MemDB

    kw = {} if device is None else {"device": device}
    dev = torch.device("cuda" if device is None else device)

    def run(name, *a, **k):
        if log is not None:
            log.run = name
        return _harness_run(name, *a, **k)

    def register_checker():
        return W.register_tester(device="cpu")["checker"]

    random.seed(10)
    run("x1", W.register_tester(time_limit=limit_s, **kw), dev, rec,
        register_checker)
    random.seed(20)
    db = MemDB(**X2_CHAOS)
    pending = run("x2", W.register_tester(
        connect=db.connect, time_limit=limit_s, **kw), dev, rec,
        register_checker, defer=True)
    random.seed(30)
    t = W.register_tester(time_limit=limit_s, **kw)
    t["client"], planted = _planted_read(t["client"], *X3_PLANT)
    t.update({"name": "independent", "concurrency": X3_CLIENTS,
              "generator": _x3_generator(limit_s)})

    def plant(out, r):
        from comdb2_tpu_torch.checker.independent import subhistory

        k = X3_PLANT[0]
        sub = subhistory(k, out["history"])
        at = [i for i, op in enumerate(sub) if op.type == "ok"
              and op.f == "read" and op.value == X3_PLANT[1]]
        r["planted"] = {"key": k, "value": X3_PLANT[1], "at": at,
                        "op-index": out["results"]["linearizable"][
                            "results"].get(k, {}).get("op-index")}
    run("x3", t, dev, rec, register_checker, capture=plant)
    random.seed(40)
    t = W.register_tester(time_limit=limit_s, **kw)
    t["name"] = "register-stale-read"
    gate = _StaleRead(t["concurrency"])
    t["generator"] = gate.generator(t["generator"])
    t["client"] = gate.client(t["client"])
    arts = ("independent/1/linear.svg", "timeline.html",
            "latency-raw.svg", "latency-quantiles.svg", "rate.svg")

    def keep(out, r):
        from comdb2_tpu_torch.harness import store

        r["stale_read"] = gate.lie
        r["artifacts"] = {a: os.path.getsize(store.path(out, a))
                          if os.path.exists(store.path(out, a)) else None
                          for a in arts}
        dst = os.path.join(HERE, "chiprun_out", "harness_x4")
        os.makedirs(dst, exist_ok=True)
        for a in arts:
            if r["artifacts"][a] is not None:
                shutil.copy(store.path(out, a),
                            os.path.join(dst, os.path.basename(a)))
    run("x4", t, dev, rec, register_checker, capture=keep)
    random.seed(50)
    run("x5_sets", W.sets_test(connect=_lossy_connect(), **kw), dev, rec,
        lambda: W.sets_test(device="cpu")["checker"])
    random.seed(60)
    t = W.g2_test(**kw)
    t["client"] = _broken_g2_client()
    run("x5_g2", t, dev, rec, lambda: W.g2_test(device="cpu")["checker"])
    return pending


def _harness_path(zero_counts, counts):
    """Path 8: the Jepsen harness in process on the card — (x1) the
    register test at the reference's settings, (x2) with a chaos
    backend, (x3) the ``jepsen.independent`` shape with one planted
    read, (x4) a stale read, (x5) a lossy sets backend and a broken G2
    backend — then every launch it made held against the plain version.
    Returns ``(rec, launches, pending)``: ``pending.finish()`` waits for
    (x2)'s re-check by the plain versions, which runs on in a child
    process."""
    from comdb2_tpu_torch.utils import compile_guard as CG

    rec: dict = {}
    log = _LaunchLog()
    log.install()
    CG.time_launches(True)
    zero_counts()
    t_path = time.perf_counter()
    try:
        pending = _harness_runs(None, rec, log)
    finally:
        CG.time_launches(False)
        log.uninstall()
    launches = counts()
    rec["runs_wall_s"] = time.perf_counter() - t_path
    err, held, plain_ms = _hold_launches(log)
    rec["hold"] = {"launches": len(log.launches), "max_abs_err": err,
                   "plain_ms": plain_ms, "by_run": held}
    print(f"  {len(log.launches)} segment-search launches of the path "
          f"bit-equal to seg_search_reference (single-history launches and "
          f"the stream launches' longest and INVALID groups on the same "
          f"card tensors, every stream group on CPU copies; plain version "
          f"{plain_ms:.1f} ms for all): "
          + "; ".join(f"{run} {len(v['single'])} single, "
                      f"{len(v['stream'])} stream" for run, v in held.items()))
    rec["wall_s"] = time.perf_counter() - t_path
    try:
        _harness_checks(rec)
    except _Failed:
        pending.kill()
        raise
    return rec, launches, pending


def _harness_checks(rec):
    """Path 8's verdicts: each as stated, none holding an error, each
    equal to the plain versions' re-check of its history (for (x2), once
    its child process has answered: :meth:`_DeferredRecheck.finish`);
    (x3)'s stream
    launch INVALID in one lane, at the segment where key 3's solo
    re-check fails, and key 3's op index the planted read's."""
    x1, x2, x3, x4 = (rec[k] for k in ("x1", "x2", "x3", "x4"))
    for name, r in rec.items():
        if isinstance(r, dict) and "valid" in r:
            _expect(not r["error"], f"({name}) a result holds an error: "
                                    f"{r}")
            _expect(r.get("equal_to_cpu", name == "x2"),
                    f"({name}) differs from the plain versions' re-check: "
                    f"{r}")
    _expect(x1["valid"] is True and x1["launches"]["seg_search"] >= 1,
            f"(x1) not VALID from the kernel: {x1}")
    _expect(x2["valid"] is True and x2["infos"] > 0,
            f"(x2) not VALID, or no info op: {x2}")
    x3_held = rec["hold"]["by_run"].get("x3", {"single": [], "stream": []})
    stream = x3_held["stream"]
    solo = [s for s in x3_held["single"] if s["status"] != 0]
    p = x3["planted"]
    _expect(x3["valid"] is False and x3["keys"] > 1
            and x3["failures"] == [p["key"]]
            and x3["launches"]["seg_search_stream"] == 1
            and x3["launches"]["seg_search"] >= 1
            and len(stream) == 1 and len(stream[0]["invalid"]) == 1
            and len(p["at"]) == 1 and p["op-index"] == p["at"][0]
            and solo and all(s["fail"] == stream[0]["invalid"][0][5]
                             for s in solo),
            f"(x3) not INVALID on key {p['key']} alone, at the planted "
            f"read, from one stream launch and a solo re-check: {x3}, "
            f"launches {x3_held}")
    _expect(x4["valid"] is False and x4["failures"] == [1]
            and (x4["stale_read"] or {}).get("stale") is not None
            and x4["launches"]["seg_search"] >= 1
            and all(v for v in x4["artifacts"].values()),
            f"(x4) the stale read was not caught with its artifacts: {x4}")
    _expect(rec["x5_sets"]["valid"] is False
            and rec["x5_g2"]["valid"] is False,
            f"(x5) a broken backend passed: {rec['x5_sets']}, "
            f"{rec['x5_g2']}")


CLUSTER_NODES = ("m1", "m2", "m3", "m4", "m5")   # (c1): the reference's fleet
CLUSTER_LIMIT_S = 10.0    # (c1): the limit of (x1)
C2_SEEDS = (41, 42, 43, 44)   # (c2): the reference test's seeds
C2_KEYS = 8               # (c2): registers of the keyed mix
C3_LIMIT_S = 4.0          # (c3): the reference test's limit


def _sut_node() -> str:
    """The ``sut_node`` binary path 9 runs; raises when it is not built
    (the native build at the script's start builds it with cmake)."""
    path = os.path.join(HERE, "native", "build", "sut_node")
    if not os.path.exists(path):
        raise _Failed(f"(c) {path} is not built; see native/build/build.log "
                      f"(cmake --build native/build --target sut_node)")
    return path


def _free_ports(n):
    """``n`` distinct localhost ports the OS handed out."""
    import socket

    socks = []
    try:
        for _ in range(n):
            sk = socket.socket()
            sk.bind(("127.0.0.1", 0))
            socks.append(sk)
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _c1_test(binary, base_dir, kw):
    """(c1): ``register-test-nemesis`` at the reference's shape — five
    ``sut_node`` nodes provisioned by ``SutNodeDB`` over ``LocalRemote``,
    concurrency 10, [w cas cas r] staggered 0.02 s on key 1 for
    ``CLUSTER_LIMIT_S``, and the master+1 breaknet partitioner isolating
    the primary in two windows; the tester's own checkers. Returns the
    test map, its ports and its DB."""
    from comdb2_tpu_torch.control.remote import LocalRemote
    from comdb2_tpu_torch.harness import generator as G
    from comdb2_tpu_torch.harness.provision import SutNodeDB, local_layout
    from comdb2_tpu_torch.workloads import comdb2 as W
    from comdb2_tpu_torch.workloads.tcp import (ClusterControl,
                                                ClusterPartitioner,
                                                TcpClusterRegisterClient)

    ports = _free_ports(len(CLUSTER_NODES))
    db = SutNodeDB(LocalRemote(), binary,
                   local_layout(CLUSTER_NODES, ports), base_dir=base_dir,
                   timeout_ms=300, elect_ms=500, lease_ms=300)
    steps = [G.sleep(1.5), {"type": "info", "f": "start"}, G.sleep(2.0),
             {"type": "info", "f": "stop"}, G.sleep(1.5),
             {"type": "info", "f": "start"}, G.sleep(2.0),
             {"type": "info", "f": "stop"}]
    t = W.register_tester_nemesis(opts={
        "nodes": list(CLUSTER_NODES), "db": db,
        "client": TcpClusterRegisterClient(ports, timeout_s=1.0,
                                           mutate_retries=8),
        "nemesis": ClusterPartitioner(ClusterControl(ports),
                                      isolate_primary=True),
        "generator": G.phases(
            G.nemesis(G.seq(steps), G.time_limit(
                CLUSTER_LIMIT_S, G.stagger(0.02, G.clients(
                    G.mix([W.w, W.cas, W.cas, W.r]))))),
            G.log("quiesce"), G.sleep(1.0)),
    }, **kw)
    return t, ports, db


def _c2_generator(seed):
    """(c2): the reference's split-brain run — ops over ``C2_KEYS``
    registers, each process from its own rng of (seed, process, f),
    for 6 s, with two 2 s partition windows."""
    from comdb2_tpu_torch.harness import generator as G
    from comdb2_tpu_torch.ops.kv import tuple_

    def keyed(f):
        rngs = {}

        def op(test=None, process=None):
            rng = rngs.get(process)
            if rng is None:
                rng = rngs[process] = random.Random(f"{seed}/{process}/{f}")
            k = rng.randrange(C2_KEYS)
            if f == "read":
                return {"type": "invoke", "f": "read",
                        "value": tuple_(k, None)}
            if f == "write":
                return {"type": "invoke", "f": "write",
                        "value": tuple_(k, rng.randrange(5))}
            return {"type": "invoke", "f": "cas",
                    "value": tuple_(k, (rng.randrange(5),
                                        rng.randrange(5)))}
        return op

    steps = [G.sleep(0.4)]
    for _ in range(2):
        steps += [{"type": "info", "f": "start"}, G.sleep(2.0),
                  {"type": "info", "f": "stop"}, G.sleep(0.8)]
    return G.nemesis(G.seq(steps), G.time_limit(6.0, G.stagger(
        0.01, G.mix([keyed("read"), keyed("read"), keyed("write"),
                     keyed("cas")]))))


def _cluster_runs(device, rec, log=None):
    """(c1)-(c3) on ``device`` (``None``, the testers' default, is the
    card), each history re-checked at ``device="cpu"``, (c1)'s in a
    child process: returns its :class:`_DeferredRecheck`. Every node is
    killed on the way out."""
    import shutil

    import torch

    from comdb2_tpu_torch.checker import checkers as C
    from comdb2_tpu_torch.checker import independent as I
    from comdb2_tpu_torch.harness import fake
    from comdb2_tpu_torch.harness import generator as G
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.txn import closure_torch as TCL
    from comdb2_tpu_torch.workloads import comdb2 as W
    from comdb2_tpu_torch.workloads.tcp import (ClusterControl,
                                                ClusterPartitioner,
                                                ListAppendTcpClient,
                                                TcpClusterRegisterClient,
                                                spawn_cluster)

    binary = _sut_node()
    kw = {} if device is None else {"device": device}
    dev = torch.device("cuda" if device is None else device)

    def run(name, *a, **k):
        if log is not None:
            log.run = name
        return _harness_run(name, *a, **k)

    def starts(out, r):
        r["nemesis_starts"] = sum(op.process == "nemesis" and op.f == "start"
                                  and op.type == "info"
                                  for op in out["history"]) // 2

    base = tempfile.mkdtemp(prefix="chip_smoke_c1_sut_")
    random.seed(70)
    t, ports, db = _c1_test(binary, base, kw)
    try:
        pending = run("c1", t, dev, rec,
                      lambda: W.register_tester(device="cpu")["checker"],
                      capture=starts, defer=True, keep_nodes=True)
    finally:
        ClusterControl(ports).heal()
        for node in CLUSTER_NODES:
            db.teardown(t, node)
        shutil.rmtree(base, ignore_errors=True)
    try:
        rec["c2_seeds"] = []
        for seed in C2_SEEDS:
            ports = _free_ports(3)
            procs = spawn_cluster(binary, ports, durable=True,
                                  timeout_ms=300, elect_ms=500,
                                  lease_ms=300, flags=["-B"])
            try:
                ctl = ClusterControl(ports)
                t = fake.noop_test(**kw)
                t.update({
                    "concurrency": 5, "name": f"cluster-splitbrain-{seed}",
                    "client": TcpClusterRegisterClient(ports,
                                                       timeout_s=0.45),
                    "model": cas_register(),
                    "nemesis": ClusterPartitioner(ctl,
                                                  isolate_primary=True),
                    "generator": _c2_generator(seed),
                    "checker": C.compose({"linearizable": I.checker(
                        C.Linearizable(**kw))})})
                run("c2", t, dev, rec, lambda: C.compose({
                    "linearizable": I.checker(
                        C.Linearizable(device="cpu"))}))
            finally:
                ClusterControl(ports).heal()
                procs.kill9_all()
            rec["c2_seeds"].append([seed, rec["c2"]["valid"]])
            if rec["c2"]["valid"] is False:
                break
        ports = _free_ports(3)
        procs = spawn_cluster(binary, ports, durable=True, timeout_ms=500,
                              elect_ms=500, lease_ms=300)
        try:
            t = fake.noop_test(**kw)
            t.update({
                "concurrency": 5, "name": "la-cluster",
                "client": ListAppendTcpClient(ports, timeout_s=0.6),
                "model": None,
                "generator": G.clients(G.time_limit(C3_LIMIT_S, G.stagger(
                    0.01, W.list_append_gen(n_keys=3)))),
                "checker": C.Serializable(backend="device", **kw)})

            d0 = TCL.DISPATCHES

            def host(out, r):
                r["closure_dispatches"] = TCL.DISPATCHES - d0
                h = out["history"]
                t0 = time.perf_counter()
                want = C.Serializable(backend="host").check({}, None, h)
                r["host_s"] = time.perf_counter() - t0
                res = out["results"]
                r["equal_to_host"] = res == want
                r["txns"] = res.get("txn-count")
                r["edges"] = res.get("edge-count")
            run("c3", t, dev, rec,
                lambda: C.Serializable(backend="device", device="cpu"),
                capture=host)
            # the plain re-check's closure calls compare, they are not
            # the path's
            rec["comparison_closures"] = (TCL.DISPATCHES - d0
                                          - rec["c3"]["closure_dispatches"])
        finally:
            procs.kill9_all()
    except BaseException:
        pending.kill()
        raise
    return pending


def _cluster_path(zero_counts, counts):
    """Path 9: the TCP cluster half of the harness on the card — (c1)
    ``register-test-nemesis`` over five ``sut_node`` nodes, (c2) the
    ``-B`` split-brain control, (c3) list-append over the cluster —
    then every segment-search launch it made held against the plain
    version. Returns ``(rec, launches, pending)``: ``pending.finish()``
    waits for (c1)'s re-check by the plain versions in a child
    process."""
    from comdb2_tpu_torch.utils import compile_guard as CG

    rec: dict = {}
    log = _LaunchLog()
    log.install()
    CG.time_launches(True)
    zero_counts()
    t_path = time.perf_counter()
    try:
        pending = _cluster_runs(None, rec, log)
    finally:
        CG.time_launches(False)
        log.uninstall()
    launches = counts()
    launches["closure_diag"] -= rec.get("comparison_closures", 0)
    rec["runs_wall_s"] = time.perf_counter() - t_path
    try:
        err, held, plain_ms = _hold_launches(log, "path 9")
        rec["hold"] = {"launches": len(log.launches), "max_abs_err": err,
                       "plain_ms": plain_ms, "by_run": held}
        print(f"  {len(log.launches)} segment-search launches of the path "
              f"bit-equal to seg_search_reference (plain version "
              f"{plain_ms:.1f} ms for all): "
              + "; ".join(f"{run} {len(v['single'])} single, "
                          f"{len(v['stream'])} stream"
                          for run, v in held.items()))
        rec["wall_s"] = time.perf_counter() - t_path
        for name in ("c1", "c2", "c3"):
            r = rec[name]
            print(f"  {name}: valid={r['valid']!r}, engines "
                  f"{r.get('engines', 'closure_diag')}, effective slots "
                  f"{r.get('slots')}, launches "
                  f"{ {k: v for k, v in r['launches'].items() if v} }"
                  + (f" and {r['closure_dispatches']} closure calls"
                     if "closure_dispatches" in r else "")
                  + f", card {r['card_ms']:.3f} ms in the launches; "
                  f"harness {r['harness_wall_s']:.2f} s, check "
                  f"{r['check_wall_s']:.2f} s, plain re-check "
                  + (f"{r['cpu_recheck_s']:.2f} s" if "cpu_recheck_s" in r
                     else "in a child process (below)"))
        _cluster_checks(rec, launches)
    except _Failed:
        pending.kill()
        raise
    return rec, launches, pending


def _cluster_checks(rec, launches):
    """Path 9's verdicts: none holding an error; (c2) and (c3) equal to
    the plain versions' re-checks ((c1) once its child answers); (c1)
    VALID from the kernel or the seg2 ladder with both partition
    windows; (c2) INVALID from the kernel; (c3) VALID from the
    closure on the card, equal to the host checker."""
    c1, c2, c3 = rec["c1"], rec["c2"], rec["c3"]
    for name in ("c1", "c2", "c3"):
        _expect(not rec[name]["error"],
                f"({name}) a result holds an error: {rec[name]}")
    for name in ("c2", "c3"):
        _expect(rec[name].get("equal_to_cpu"),
                f"({name}) differs from the plain versions' re-check: "
                f"{rec[name]}")
    held = rec["hold"]["by_run"]
    _expect(c1["valid"] is True and c1["launches"]["seg_search"] >= 1
            and set(c1["engines"]) <= {"cuda-seg", "torch-seg2"}
            and max(c1["slots"]) <= 16
            and c1["nemesis_starts"] >= 2,
            f"(c1) not VALID from cuda-seg / torch-seg2 at <= 16 slots "
            f"with two partition windows: {c1}")
    invalid = [s for s in held.get("c2", {}).get("single", [])
               if s["status"] == 1] + [
        v for s in held.get("c2", {}).get("stream", [])
        for v in s["invalid"]]
    _expect(c2["valid"] is False and c2["failures"] and invalid,
            f"(c2) the split-brain control was not INVALID from the "
            f"kernel in seeds {rec['c2_seeds']}: {c2}")
    _expect(c3["valid"] is True and c3["equal_to_host"]
            and (c3["txns"] or 0) >= 20 and (c3["edges"] or 0) >= 10
            and launches["closure_diag"] >= 1,
            f"(c3) list-append not VALID from the closure on the card, "
            f"or unlike the host checker: {c3}, launches {launches}")


# --- path 10: static analysis on the card ------------------------------------

class _PairSortLog:
    """Every ``pair_sort`` call on the card while installed, with copies
    of its inputs and outputs, for holding against the plain version."""

    def __init__(self):
        self.calls = []
        self._real = None

    def install(self):
        from comdb2_tpu_torch.checker import pair_sort as PSORT

        real = self._real = PSORT.pair_sort
        log = self

        def logged(hi, lo, lib=None):
            out = real(hi, lo, lib)
            if hi.is_cuda:
                log.calls.append((hi.clone(), lo.clone(), out[0].clone(),
                                  out[1].clone()))
            return out
        PSORT.pair_sort = logged

    def uninstall(self):
        from comdb2_tpu_torch.checker import pair_sort as PSORT

        PSORT.pair_sort = self._real

    def hold(self) -> int:
        """Max abs difference of every logged call from
        ``pair_sort_reference`` on the same card tensors."""
        from comdb2_tpu_torch.checker import pair_sort as PSORT

        err = 0
        for hi, lo, h_k, l_k in self.calls:
            h_p, l_p = PSORT.pair_sort_reference(hi, lo)
            err = max(err, int((h_k.long() - h_p.long()).abs().max()),
                      int((l_k.long() - l_p.long()).abs().max()))
        return err


def _analysis_path(zero_counts, counts):
    """Path 10: (an1) the port's static passes in a child process,
    overlapping (an2) the Hopper budget read back from the built
    libraries, (an3) the mixed workload under the launch guard with
    every launch held against the plain versions, (an4) the fuzz on the
    card. Returns ``(rec, launches)``; raises ``_Failed`` (or the
    prover's ``CompileSurfaceError``) on any failure."""
    import importlib.util

    from comdb2_tpu_torch.analysis import compile_surface, kernel_budget

    rec: dict = {}
    t_path = time.perf_counter()
    static = subprocess.Popen(
        [sys.executable, "-m", "comdb2_tpu_torch.analysis"], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # (an2) the budget, read back from the built kernels
        t0 = time.perf_counter()
        findings, report = kernel_budget.check_built()
        rec["an2"] = dict(report, wall_s=time.perf_counter() - t0,
                          findings=[f.format() for f in findings])
        print(f"  an2 Hopper budget: {report['tiers']} production tiers; "
              f"at most {report['max_smem_bytes']} bytes of dynamic shared "
              f"memory per CTA at {kernel_budget._seg_kernel().WARPS_PER_CTA}"
              f" warps over a {kernel_budget._seg_kernel().MAX_TABLE}-entry "
              f"table (the library's, equal to the Python mirror at every "
              f"tier) against the card's opt-in "
              f"{report['smem_optin_bytes']}; at least "
              f"{report['min_warp_streams_per_sm']} warp-streams per SM; "
              f"pair sort {report['pair_sort_smem_bytes']} bytes per CTA")
        print("  an2 kernels: " + "; ".join(
            f"{k} {a['registers']} registers, {a['local_bytes']} bytes "
            f"local" for k, a in report["kernels"].items()))
        _expect(not findings, f"(an2) the Hopper budget: "
                              f"{[f.format() for f in findings]}")
        # (an3) the mixed workload under the guard, every launch held
        log, sorts = _LaunchLog(), _PairSortLog()
        log.install()
        sorts.install()
        zero_counts()
        t0 = time.perf_counter()
        try:
            res = compile_surface.mixed_workload("cuda")
        finally:
            sorts.uninstall()
            log.uninstall()
        launches = counts()
        rec["an3"] = dict(res, wall_s=time.perf_counter() - t0)
        print(f"  an3 mixed workload: {len(res['variants'])} variants "
              f"inside the static inventory "
              f"({', '.join(res['variants'])}); shrink "
              f"{res['shrink_steps']} steps; unbucketed control caught: "
              f"{res['control'].splitlines()[-1].strip()}; "
              f"{rec['an3']['wall_s']:.2f} s")
        _expect(res["control"] is not None
                and {v.split(" ", 1)[0] for v in res["variants"]}
                == {"seg_search", "seg_search_stream", "pair_sort"},
                f"(an3) the mixed workload missed a kernel: {res}")
        err, held, plain_ms = _hold_launches(log, "path 10")
        err_p = sorts.hold()
        rec["an3"]["hold"] = {"launches": len(log.launches),
                              "max_abs_err": err, "plain_ms": plain_ms,
                              "pair_sort_calls": len(sorts.calls),
                              "pair_sort_max_abs_err": err_p}
        print(f"  an3 {len(log.launches)} segment-search launches "
              f"bit-equal to seg_search_reference (plain {plain_ms:.1f} "
              f"ms for all); {len(sorts.calls)} pair_sort calls "
              f"{'bit-equal' if err_p == 0 else f'max diff {err_p}'} to "
              f"pair_sort_reference")
        _expect(err_p == 0, f"(an3) pair_sort differs from its plain "
                            f"version: max diff {err_p}")
        # (an4) the fuzz on the card
        spec = importlib.util.spec_from_file_location(
            "torch_fuzz_seg", os.path.join(HERE, "scripts",
                                           "torch_fuzz_seg.py"))
        fuzz = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fuzz)
        out = os.path.join(HERE, "chiprun_out", "fuzz_torch.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        zero_counts()
        t0 = time.perf_counter()
        rc = fuzz.main([str(ANALYSIS_FUZZ_SEEDS), "--device", "cuda",
                        "--out", out])
        fuzz_counts = counts()
        with open(out) as fh:
            art = json.load(fh)
        rec["an4"] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                      "artifact": art, "launches": fuzz_counts}
        print(f"  an4 fuzz at {ANALYSIS_FUZZ_SEEDS} seeds per family: "
              f"{art['verdict']}, {art['total_cross_checked']} cross-checked"
              f" against seg2, {art['renamed_slots_cross_checked']} renamed, "
              f"{art['stream_histories_cross_checked']} streamed; "
              f"{rec['an4']['wall_s']:.2f} s")
        _expect(rc == 0 and art["verdict"] == "PASS",
                f"(an4) the fuzz failed: {art}")
        for k, v in fuzz_counts.items():
            launches[k] += v
        # (an1) the static passes, joined last
        t0 = time.perf_counter()
        out_s, err_s = static.communicate(timeout=600)
        rec["an1"] = {"rc": static.returncode,
                      "passes": [ln for ln in err_s.splitlines()
                                 if ln.startswith("pass ")],
                      "waited_s": time.perf_counter() - t0}
        print(f"  an1 python -m comdb2_tpu_torch.analysis: exit "
              f"{static.returncode}, {out_s.strip().splitlines()[-1:]}; "
              + "; ".join(ln[5:] for ln in rec["an1"]["passes"]))
        _expect(static.returncode == 0,
                f"(an1) the static passes failed:\n{out_s}{err_s}")
    finally:
        if static.poll() is None:
            static.kill()
            static.wait()
    rec["wall_s"] = time.perf_counter() - t_path
    return rec, launches



# --- path 11: the elastic fleet and the gate on the card ---------------------

FLEET_PER_CLASS = 2       # (el): requests per size class of torch_elastic
FLEET_I_KEYS = 32         # (el): (i)'s keys in the first burst
FLEET_I_JOIN = 16         # (el): (i)'s keys in the join's burst
FLEET_F = 1024            # (el): the daemons' frontier (the (h) lane's keys rung)
MXU_FUZZ_SEEDS = 6        # (mz): seeds per family


def _fleet_scripts():
    """The port's fleet scripts under ``scripts/``: ``(torch_elastic,
    torch_fleet, torch_fuzz_mxu)``."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_elastic
    import torch_fleet
    import torch_fuzz_mxu

    return torch_elastic, torch_fleet, torch_fuzz_mxu


class _DeferredGate:
    """(gt): ``scripts/check_torch.sh --json --device cuda`` in a child
    process (its own session, so it dies whole with the script) that
    overlaps the rest of the script; :meth:`finish` waits for it and
    reads one JSON line per stage. Its stderr goes to
    ``chiprun_out/check_torch.err``."""

    def __init__(self):
        import atexit

        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        self.err = os.path.join(HERE, "chiprun_out", "check_torch.err")
        with open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                ["bash", os.path.join(HERE, "scripts", "check_torch.sh"),
                 "--json", "--device", "cuda"], cwd=HERE,
                stdout=subprocess.PIPE, stderr=err, text=True,
                start_new_session=True)
        self.t0 = time.perf_counter()
        atexit.register(self.kill)

    def kill(self):
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def finish(self, rec, timeout_s=900.0):
        try:
            out, _ = self.proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            raise _Failed(f"(gt) check_torch.sh took more than {timeout_s} s")
        stages = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
        rec["gt"] = {"rc": self.proc.returncode, "stages": stages,
                     "waited_s": time.perf_counter() - self.t0}
        with open(self.err) as fh:
            tail = fh.read()[-3000:]
        print("  gt check_torch.sh --json --device cuda: exit "
              f"{self.proc.returncode}, "
              + ", ".join(f"{st['stage']} {'ok' if st['ok'] else 'FAILED'} "
                          f"{st['secs']} s" for st in stages)
              + f"; {rec['gt']['waited_s']:.1f} s after its start")
        want = ["analysis", "txn-smoke", "shrink-smoke", "wl", "mxu-smoke",
                "multichip", "service-smoke", "stream", "routing",
                "elastic", "obs"]
        _expect(self.proc.returncode == 0
                and [st["stage"] for st in stages] == want
                and all(st["ok"] for st in stages),
                f"(gt) the gate failed: {stages}; its stderr ends:\n{tail}")


def _fleet_references(dev):
    """(el)'s traffic and the in-process ``check_batch`` on the card that
    every fleet reply is held to, made before the path's counted run:
    the first burst is torch_elastic's size classes, FLEET_I_KEYS of
    (i)'s keys and one of (h)'s overflowing 8-process lanes; the join's
    burst the size classes again and FLEET_I_JOIN more keys; the
    migrated session one more key."""
    from comdb2_tpu_torch.checker import batch as TB
    from comdb2_tpu_torch.models.model import cas_register

    EL, _, _ = _fleet_scripts()
    per, _ = _i_histories()
    burst = EL.class_histories(FLEET_PER_CLASS, 9000, 37) \
        + per[:FLEET_I_KEYS]
    burst.insert(len(burst) // 2, EL.overflow_history())
    join = EL.class_histories(FLEET_PER_CLASS, 5000, 31) \
        + per[FLEET_I_KEYS:FLEET_I_KEYS + FLEET_I_JOIN]
    hs = burst + join
    want = TB.check_batch(TB.pack_batch(hs, cas_register()), F=FLEET_F,
                          device=dev)
    return {"burst": burst, "join": join,
            "stream": per[FLEET_I_KEYS + FLEET_I_JOIN],
            "want": {id(h): (int(want[0][i]), int(want[1][i]),
                             int(want[2][i])) for i, h in enumerate(hs)}}


def _fleet_el(ref, rec):
    """(el): torch_elastic's three scenarios with the daemons on the
    card, at ``--frontier`` FLEET_F, on ``ref``'s traffic; every reply
    held to the in-process ``check_batch``. Returns the fleet's kernel
    launches, read from each daemon's ``metrics`` verb."""
    from comdb2_tpu_torch.service import protocol

    EL, _, _ = _fleet_scripts()
    log_dir = os.path.join(HERE, "chiprun_out", "fleet_daemons")
    t0 = time.perf_counter()
    try:
        out = EL.run("cuda", FLEET_PER_CLASS, log_dir=log_dir,
                     frontier=FLEET_F, burst=ref["burst"],
                     join_burst=ref["join"], stream_history=ref["stream"],
                     keep_replies=True)
    except BaseException:
        from comdb2_tpu_torch.service.supervisor import stderr_tail

        for name in sorted(os.listdir(log_dir) if os.path.isdir(log_dir)
                           else []):
            print(f"  el {name}"
                  f"{stderr_tail(os.path.join(log_dir, name))}")
        raise
    wall = time.perf_counter() - t0
    replies = out.pop("replies")
    bad = []
    for i, (h, r) in sorted(replies.items()):
        st, fa, nf = ref["want"][id(h)]
        if not (r.get("ok") and r.get("valid") == protocol.verdict(st)
                and r.get("op_index") == fa
                and (st != 0 or r.get("final_count") == nf)):
            bad.append((i, st, fa, nf, {k: r.get(k) for k in (
                "ok", "valid", "op_index", "final_count", "error")}))
    n_inv = sum(r.get("valid") is False for _, r in replies.values())
    rec["el"] = dict(out, wall_s=wall, replies_held=len(replies),
                     mismatched=bad, invalid_replies=n_inv)
    k, j, m, sc = out["kill"], out["join"], out["stream"], out["self_check"]
    print(f"  el kill: {k['requests']} requests, SIGKILL of {k['victim']} "
          f"(exit {k['victim_exit']}) at request {k['killed_at_request']}; "
          f"{k['failovers']} failovers, {k['ring_refreshes']} ring "
          f"refreshes, {k['stale_cleanups']} stale registration deleted, "
          f"{k['deaths_reaped']} corpse reaped, the floor refilled "
          f"{k['respawned_to_floor']}; {k['survivor']} served "
          f"{k['survivor_served_after_kill']} after the kill")
    print(f"  el join: {j['service']}, epoch {j['epoch_before']} -> "
          f"{j['epoch_after']}, {j['remapped_fraction']:.4f} of 512 probe "
          f"keys remapped, all onto it {j['moved_only_to_newcomer']}, it "
          f"served {j['newcomer_served']}")
    print(f"  el migration: {m['pinned']} drained, the session moved to "
          f"{m['migrated_to']} ({m['migrations']} move), rung "
          f"{m['engine_before']} -> {m['engine_after']}, "
          f"{m['replays_after_handoff']} replays, dispatches "
          f"{m['dispatches_first_half']} then {m['dispatches_total']}, "
          f"final {m['final_valid']}")
    print(f"  el self-check: {sc['requests']} requests answered exactly "
          f"once {sc['answered_exactly_once']}, the fleet history "
          f"({sc['fleet_history_ops']} ops) {sc['fleet_history_valid']} "
          f"through {sc['checker_engine']}; {len(replies)} replies "
          f"({n_inv} INVALID) "
          f"{'all equal' if not bad else f'{len(bad)} differ from'} the "
          f"in-process check_batch at F = {FLEET_F}")
    for svc, d in sorted(out["daemons"].items()):
        print(f"  el {svc}: {d.get('completed', 0)} requests completed; "
              f"launches seg_search {d.get('seg_search', 0)}, "
              f"seg_search[stream] {d.get('seg_search_stream', 0)}, "
              f"pair_sort {d.get('pair_sort', 0)}; card "
              f"{d.get('card_s', 0.0) * 1e3:.3f} ms (its metrics verb)")
    w = out["walls_s"]
    print("  el walls (s): " + ", ".join(f"{k_} {v:.2f}"
                                         for k_, v in w.items())
          + f"; all {wall:.1f}")
    print(f"  el leftovers: {out['leftovers']}")
    _expect(not bad, f"(el) fleet replies differ from check_batch: "
                     f"{bad[:4]}")
    _expect(out["gate_ok"], f"(el) the elastic gate failed: "
                            f"{ {k_: out[k_] for k_ in ('kill', 'join', 'stream', 'self_check', 'leftovers', 'fleet_launches')} }")
    return out["fleet_launches"]


def _fleet_mz(rec, counts):
    """(mz): torch_fuzz_mxu on the card, every segment-search launch it
    makes in process held to ``seg_search_reference``."""
    _, _, FZ = _fleet_scripts()
    log = _LaunchLog()
    log.run = "mz"
    log.install()
    t0 = time.perf_counter()
    try:
        art = FZ.run(MXU_FUZZ_SEEDS, "cuda")
    finally:
        log.uninstall()
    wall = time.perf_counter() - t0
    here = counts()                 # (el) launches in its daemons only
    err, held, plain_ms = _hold_launches(log, "path 11 (mz)")
    fams = art["families"]
    rec["mz"] = {"wall_s": wall, "families": fams, "device": art["device"],
                 "verdict": art["verdict"], "launches": here,
                 "hold": {"launches": len(log.launches), "max_abs_err": err,
                          "plain_ms": plain_ms}}
    print(f"  mz torch_fuzz_mxu at {MXU_FUZZ_SEEDS} seeds per family on "
          f"{art['device']}: {art['verdict']}; " + "; ".join(
              f"{f} {c}" for f, c in fams.items())
          + f"; {wall:.2f} s; its {len(log.launches)} segment-search "
          f"launches bit-equal to seg_search_reference ({plain_ms:.1f} ms "
          "plain)")
    _expect(art["verdict"] == "PASS"
            and fams["register"].get("kernel-crosschecked", 0) > 0
            and all(fams[f].get("ok") and fams[f].get("inv") for f in fams)
            and not fams["waves-p16"].get("unk")
            and not fams["waves-p24"].get("unk"),
            f"(mz) the MXU fuzz fell short: {fams}")
    return err


def _start_gate():
    """(gt), started before path 9 so that it overlaps paths 9-11 and
    the script's tail: ``ct_pmux`` is built first (once, for the gate
    and (el) alike)."""
    _, FL, _ = _fleet_scripts()
    FL.find_ct_pmux()
    return _DeferredGate()


def _fleet_path(dev, zero_counts, counts):
    """Path 11: (el) the elastic fleet on the card, with (mz) the MXU
    fuzz in a thread beside it ((el)'s process only waits on its
    daemons; (gt) runs in its child process since path 9). Returns
    ``(rec, launches)``: the path's counts are this process's ((mz))
    plus the fleet's daemons' ((el), scraped)."""
    import threading

    t0 = time.perf_counter()
    ref = _fleet_references(dev)
    print(f"  (direct calls for the comparisons: "
          f"{time.perf_counter() - t0:.1f} s)")
    rec: dict = {}
    zero_counts()
    t_path = time.perf_counter()
    mz: dict = {}

    def fuzz():
        try:
            mz["err"] = _fleet_mz(rec, counts)
        except BaseException as e:          # noqa: BLE001
            mz["raised"] = e

    thread = threading.Thread(target=fuzz)
    thread.start()
    try:
        fleet = _fleet_el(ref, rec)
    finally:
        thread.join()
    if "raised" in mz:
        raise mz["raised"]
    err = mz["err"]
    launches = counts()
    for name, key in (("seg_search", "seg_search"),
                      ("seg_search[stream]", "seg_search_stream"),
                      ("pair_sort", "pair_sort")):
        launches[name] += int(fleet.get(key, 0))
    rec["launches"] = {"fleet": fleet, "this_process": rec["mz"]["launches"]}
    rec["hold"] = rec["mz"]["hold"]
    rec["max_abs_err"] = err
    rec["wall_s"] = time.perf_counter() - t_path
    return rec, launches

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
    from comdb2_tpu_torch.utils import compile_guard as CG
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
        CG.LAUNCHES.update(dict.fromkeys(CG.LAUNCHES, 0))
        TCL.DISPATCHES = WB.DISPATCHES = 0
        TE.DISPATCHES = TE.MEGABATCHES = 0

    def counts():
        return {"seg_search": CG.LAUNCHES["seg_search"],
                "seg_search[stream]": CG.LAUNCHES["seg_search_stream"],
                "pair_sort": CG.LAUNCHES["pair_sort"],
                "closure_diag": TCL.DISPATCHES, "wl_check": WB.DISPATCHES,
                "stream_dispatch": TE.DISPATCHES,
                "stream_megabatch": TE.MEGABATCHES}

    # --- path 1: single-history analysis, counted ---------------------------
    t_p1 = time.perf_counter()
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
    launches = CG.LAUNCHES["seg_search"]
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
    print(f"  (path 1 took {time.perf_counter() - t_p1:.1f} s)")

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
    t_p2 = time.perf_counter()
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
        stream = {k: v for k, v in (info.get("stream") or {}).items()
                  if k != "slices"}
        print(f"request {name}: {len(batch)} histories F={F} "
              f"engine={info.get('engine')} stream={stream} "
              f"escalated={info.get('escalated')} "
              f"statuses={batch_res[name]['status_counts']} "
              f"wall {wall:.3f} s")
        return st, fa, n, info

    st_g, _, _, info_g = run_batch("g", batch_g, 128)
    st_g2, _, _, info_g2 = run_batch("g2", batch_g2, 256)
    st_h, fa_h, _, info_h = run_batch("h", batch_h, 8192)
    st_h10, fa_h10, _, info_h10 = run_batch("h10", batch_h10, 8192)
    stream_launches = CG.LAUNCHES["seg_search_stream"]
    sort_launches = CG.LAUNCHES["pair_sort"]
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
    print(f"  (path 2 took {time.perf_counter() - t_p2:.1f} s)")

    # --- path 3: the checker layer, counted -------------------------------
    print("checker layer: closure (t), check_txn (t2), workload families "
          "(w), IndependentChecker (i), filetest --checker (e2)")
    t_p3 = time.perf_counter()
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
    print(f"  (path 3 took {time.perf_counter() - t_p3:.1f} s)")
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

    # --- path 8: the Jepsen harness, counted -------------------------------
    # (run before paths 5-7: (x2)'s plain re-check in a child process, up
    # to 346 s at the seg2 ladder's top rung, then overlaps them too)
    print("harness: core.run in process on the card — (x1) the register "
          "test, (x2) with a chaos backend, (x3) the jepsen.independent "
          "shape, (x4) a stale read, (x5) lossy sets and broken G2 "
          "backends; each history re-checked by the plain versions")
    t0 = time.perf_counter()
    try:
        harness_rec, path_counts["harness"], harness_pending = \
            _harness_path(zero_counts, counts)
    except _Failed as e:
        return _fail(str(e))
    print(f"LAUNCHES (harness path): {path_counts['harness']}")
    print(f"  (path 8 took {time.perf_counter() - t0:.1f} s)")
    if not (path_counts["harness"]["seg_search[stream]"] > 0
            and path_counts["harness"]["seg_search"] > 0):
        return _fail(f"the harness path launched no segment-search "
                     f"kernel in one of its modes: {path_counts['harness']}")

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

    # --- path 7: the verifier service, counted ----------------------------
    print("service: the daemon on the card — (sv1) a burst of check "
          "requests, (sv2) txn / wl / stream / shrink requests, (sv3) the "
          "in-process core, (sv4) the mesh at D = 1, (sv5) filetest "
          "--service, (sv6) no fallback without a card")
    t0 = time.perf_counter()
    try:
        service_rec, path_counts["service"] = _service_path(
            dev, h_a, h_e, zero_counts, counts)
    except _Failed as e:
        return _fail(str(e))
    print(f"LAUNCHES (service path, this process and the daemon): "
          f"{path_counts['service']}")
    print(f"  (path 7 took {time.perf_counter() - t0:.1f} s, "
          f"{service_rec['wall_s']:.1f} s of it the counted requests)")
    if not (path_counts["service"]["seg_search[stream]"] > 0
            and path_counts["service"]["seg_search"] > 0
            and path_counts["service"]["pair_sort"] > 0):
        return _fail(f"the service path launched a kernel no time: "
                     f"{path_counts['service']}")

    # (gt) the port's gate, in a child process from here to the end
    try:
        gate_pending = _start_gate()
    except (OSError, subprocess.CalledProcessError, SystemExit) as e:
        return _fail(f"(gt) could not start: {e}")

    # --- path 9: the TCP cluster, counted ---------------------------------
    print("cluster: the TCP cluster half of the harness on the card — (c1) "
          "register-test-nemesis over five sut_node nodes, (c2) the -B "
          "split-brain control, (c3) list-append over the cluster; each "
          "history re-checked by the plain versions")
    t0 = time.perf_counter()
    try:
        cluster_rec, path_counts["cluster"], cluster_pending = \
            _cluster_path(zero_counts, counts)
    except _Failed as e:
        return _fail(str(e))
    print(f"LAUNCHES (cluster path): {path_counts['cluster']}")
    print(f"  (path 9 took {time.perf_counter() - t0:.1f} s)")
    if not (path_counts["cluster"]["seg_search"] > 0
            and path_counts["cluster"]["closure_diag"] > 0):
        return _fail(f"the cluster path launched no single-history "
                     f"segment search or no closure: "
                     f"{path_counts['cluster']}")

    # --- path 10: static analysis on the card, counted --------------------
    print("static analysis: (an1) the port's passes, (an2) the Hopper "
          "budget read back from the built kernels, (an3) the mixed "
          "workload under the launch guard, (an4) the segment-search fuzz")
    t0 = time.perf_counter()
    try:
        analysis_rec, path_counts["static analysis"] = _analysis_path(
            zero_counts, counts)
    except (_Failed, AssertionError) as e:
        return _fail(f"path 10: {e}")
    print(f"LAUNCHES (static-analysis path): "
          f"{path_counts['static analysis']}")
    print(f"  (path 10 took {time.perf_counter() - t0:.1f} s)")
    if not (path_counts["static analysis"]["seg_search"] > 0
            and path_counts["static analysis"]["seg_search[stream]"] > 0
            and path_counts["static analysis"]["pair_sort"] > 0):
        return _fail(f"the static-analysis path launched a kernel no "
                     f"time: {path_counts['static analysis']}")

    # --- path 11: the elastic fleet and the gate, counted -----------------
    print("fleet: (el) the elastic fleet on the card (SIGKILL nemesis, a "
          "join, a migration) with (mz) the MXU fuzz beside it; (gt) "
          "check_torch.sh --device cuda in the background since path 9")
    t0 = time.perf_counter()
    try:
        fleet_rec, path_counts["fleet"] = _fleet_path(
            dev, zero_counts, counts)
    except (_Failed, AssertionError) as e:
        return _fail(f"path 11: {e}")
    print(f"LAUNCHES (fleet path, this process and the daemons): "
          f"{path_counts['fleet']}")
    print(f"  (path 11 took {time.perf_counter() - t0:.1f} s; (gt) runs "
          f"on beside the rest)")
    if not (path_counts["fleet"]["seg_search"] > 0
            and path_counts["fleet"]["seg_search[stream]"] > 0
            and path_counts["fleet"]["pair_sort"] > 0):
        return _fail(f"the fleet path launched a kernel no time: "
                     f"{path_counts['fleet']}")

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
    max_err = max(max_err, err_v9, harness_rec["hold"]["max_abs_err"],
                  cluster_rec["hold"]["max_abs_err"],
                  fleet_rec["hold"]["max_abs_err"])
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
                            stream_rec["v1"]["card_ms"]["mean"]},
        "harness_path": {"parity_launches": harness_rec["hold"]["launches"],
                         "plain_ms": harness_rec["hold"]["plain_ms"]},
        "cluster_path": {"parity_launches": cluster_rec["hold"]["launches"],
                         "plain_ms": cluster_rec["hold"]["plain_ms"]},
        "fleet_path": {"parity_launches": fleet_rec["hold"]["launches"],
                       "plain_ms": fleet_rec["hold"]["plain_ms"]}}]

    # stream mode, at the main path's own launch shapes: (h)'s whole
    # launch, two of (g)'s group streams together at (g)'s layout, and
    # one group stream of nine (h) histories with an INVALID and an
    # overflowing one in the middle
    def stream_inputs(batch, info_b, geo=None):
        # one launch slice of the batch (default: the first; check_batch
        # slices a batch whose streams it builds, see TB._slice_cap)
        geo = info_b["stream"] if geo is None else geo
        streams, _ = TB._stream_segments(batch)
        streams = streams[geo["start"]:geo["end"]]
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
        if (len(plan), seg.shape[1]) != (geo["groups"], geo["rows"]):
            raise AssertionError(f"re-packed launch {len(plan)} x "
                                 f"{seg.shape[1]} != the main path's "
                                 f"{geo}")
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

    # (g)'s launches, re-timed outside the counted path: every launch
    # slice of the main path's run, each timed alone; the bound is the
    # whole (g)'s
    slices_g, bytes_g, ops_g, compares_g, need_total = [], 0, 0, 0, 0
    for k, geo in enumerate(info_g["stream"]["slices"]):
        (streams_k, stride_k, spec_k, table_k, seg_k, plan_k,
         t_k) = stream_inputs(batch_g, info_g, geo)
        n_hist_k = max(len(g_) for g_ in plan_k)
        work_k = torch.zeros(seg_k.shape[0], dtype=torch.int64, device=dev)
        need_k = torch.zeros_like(work_k)
        res_k = SK.seg_search_stream(seg_k, stride_k, table_k, spec_k,
                                     n_hist_k, work=work_k, need=need_k)
        torch.cuda.synchronize()
        slices_g.append(_time_cuda(
            lambda a=(seg_k, stride_k, table_k, spec_k, n_hist_k):
            SK.seg_search_stream(*a), 2))
        bytes_g += 4 * (seg_k.numel() + table_k.numel() + res_k.numel())
        ops_g += int(need_k.sum()) * spec_k.n_words
        compares_g += int(work_k.sum())
        need_total += int(need_k.sum())
        if k == 0:          # the first launch's groups, for the parity
            (streams_g, stride_g, spec_g, table_g, seg_g, plan_g, t_groups,
             n_hist_g, res_g, work_g, need_g) = (
                streams_k, stride_k, spec_k, table_k, seg_k, plan_k, t_k,
                n_hist_k, res_k, work_k, need_k)
        del seg_k, res_k
    ms_g = sum(slices_g)
    bound_g, by_g = _bound(bytes_g, ops_g, int32_rate)
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
        "ms": ms_g, "launches": len(slices_g), "launch_ms": slices_g,
        "bound_ms": bound_g, "bound_by": by_g,
        "compares": compares_g, "need": need_total,
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
    print(f"  g kernel: {len(slices_g)} launch(es) of the main path, "
          f"{ms_g:.3f} ms in all (each timed alone by CUDA events, mean of "
          f"2: " + ", ".join(f"{m_:.3f}" for m_ in slices_g) + " ms), the "
          f"first {seg_g.shape[0]} streams x {seg_g.shape[1]} rows; bound "
          f"{bound_g:.5f} ms ({by_g}); {n_ops_g / (ms_g / 1e3):.0f} checked "
          f"ops/s ({n_ops_g} ops); group packing {t_groups:.2f} s")
    print(f"  h kernel: {seg_h.shape[0]} streams x {seg_h.shape[1]} rows, "
          f"{ms_s:.3f} ms (CUDA events, mean of 5), plain {plain_ms_s:.1f}"
          f" ms, bound {bound_s:.5f} ms ({by_s})")
    err_s = max(err_s, service_rec["sv3"]["max_abs_err"],
                harness_rec["hold"]["max_abs_err"],
                cluster_rec["hold"]["max_abs_err"])
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
        "batch_bound_by": by_g, "batch_launch_ms": slices_g,
        "batch_measured_on": f"(g)'s {len(slices_g)} launch(es), "
                             f"{int(seg_g.shape[0])} warp streams in the "
                             f"first",
        "service_path": {"parity_groups": service_rec["sv3"][
            "checked_groups"], "plain_ms": service_rec["sv3"]["plain_ms"]},
        "harness_path": {"parity_launches": harness_rec["hold"]["launches"],
                         "plain_ms": harness_rec["hold"]["plain_ms"]},
        "cluster_path": {"parity_launches": cluster_rec["hold"]["launches"],
                         "plain_ms": cluster_rec["hold"]["plain_ms"]}})

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

    try:
        harness_pending.finish()
        cluster_pending.finish()
        gate_pending.finish(fleet_rec)
    except _Failed as e:
        return _fail(str(e))
    for e in entries:
        e["launches_by_path"] = {path: c[e["name"]]
                                 for path, c in path_counts.items()}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({"gpu": gpu, "requests": results, "batches": batch_res,
                   "checker_layer": checker_rec,
                   "last_batch_engines": escal_rec, "shrink": shrink_rec,
                   "stream": stream_rec, "service": service_rec,
                   "harness": harness_rec, "cluster": cluster_rec,
                   "static_analysis": analysis_rec, "fleet": fleet_rec,
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
