"""Verifier-service core — continuous-batching admission and fan-out.

The counterpart of the JAX package's ``service/core.py``, over the
port's engines. Transport-independent on purpose: :class:`VerifierCore`
owns the admission slots, the in-flight dispatch ring and the metrics;
the TCP daemon (:mod:`.daemon`) is a thin selector loop over it and the
unit tests drive it directly. Everything runs on ONE thread; the
overlap the ring buys is host compute against the card's: a staged
dispatch has launched its kernels and queued its results' copy into
pinned host memory behind a CUDA event, and only its ``finish`` waits
on that event. The check kind's stream engine and the txn closure stage
that way; the keys, flat, MXU and vmap engines, the workload families
and the stream sessions run their device work inside the stage call.

``device`` (``None`` means ``cuda``) is where every kind runs;
``shards=D`` > 1 builds a mesh of D devices of that type
(:func:`.sharding.make_mesh`). A failed dispatch answers ``unknown``
with the cause ``engine: ...`` and counts ``engine_errors``, as in the
JAX package, so one bad dispatch does not take down a daemon serving
other clients; nothing is re-routed to the host or the CPU.

Admission is inference-server-style continuous batching:

1. ``submit`` — backpressure first (queue at cap answers ``overload``
   with a ``retry_after_ms`` hint before any parsing work), then EDN
   parse + pack + bucket assignment. Trivial histories and malformed
   ones answer immediately; everything else is slotted into its
   bucket's forming batch. A batch that reaches the cap launches
   RIGHT THERE (``launch_full``) — no waiting for a tick round.
2. ``pump`` — the scheduler beat the daemon runs every selector
   round: expire deadline-passed requests, launch every bucket whose
   oldest request's deadline-derived launch budget expired
   (``launch_deadline``) or — on an idle round — that has any
   requests at all (``launch_idle``, so a lone serial caller never
   waits out the fill window). Launched dispatches are STAGED into a
   bounded in-flight ring (N >= 3 buckets staged/running/finalizing
   concurrently); the ring finalizes oldest-first on overflow and
   drains on idle.
3. Requests whose shape exceeds the bucket table degrade to the HOST
   engine one by one; shrink jobs advance one candidate-capped ddmin
   round per pump and re-queue.

``tick`` survives as the flush form of ``pump`` (idle semantics:
launch everything, drain the ring) — priming, shutdown and the unit
tests drive it.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..obs import trace as obs
from ..obs.metrics import Registry
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device
from . import protocol
from .bucketing import (Bucket, ServiceLimits, StreamBucket,
                        TxnBucket, WlBucket, bucket_for,
                        txn_bucket_for, wl_bucket_for, wl_dims_of)

#: the per-request stage names (docs/observability.md): they TILE the
#: measured wall per request — queue_wait (admission -> dispatch
#: begin), host_pack (columnar pack/segment/remap + stage), device
#: (launch -> the results' event observed complete, including the
#: overlap window), finalize (readback ->
#: reply) — so their sum is the request's latency_ms.
#: EVERY completed request observes all four (absent stages count as
#: 0 — deadline expiries are pure queue wait), so the four histograms
#: and the latency histogram share one count.
STAGES = ("queue_wait_ms", "host_pack_ms", "device_ms",
          "finalize_ms")

#: (n_events, batch copies) pairs primed at boot: a lone request and a
#: coalesced batch, through the real dispatch path
DEFAULT_PRIME: Tuple[Tuple[int, int], ...] = ((24, 1), (24, 8))

#: slots a non-full batch waits for mates when no deadline tightens
#: the budget (seconds) — a CAP on batch formation, not a coalescing
#: round: a full batch launches immediately and an idle wire launches
#: everything
DEFAULT_FILL_WINDOW_S = 0.005

#: staged dispatches in flight at once (staged / running /
#: finalizing): the host packs bucket i+2 while the device runs i+1
#: and i's readback completes (the JAX package's default)
DEFAULT_RING_DEPTH = 3

#: of a request's deadline headroom, the fraction admission may spend
#: waiting for batch-mates — the rest is reserved for the dispatch
#: itself (launch budget = t_in + min(fill_window, headroom * this))
LAUNCH_HEADROOM_FRACTION = 0.5


@dataclass
class PendingRequest:
    """One queued check; ``ctx`` is the transport's opaque handle (the
    daemon stores the connection there). ``kind`` is ``"check"``
    (linearizability — ``packed`` holds the PackedHistory) or
    ``"txn"`` (serializability — ``packed`` holds the inferred
    TxnGraph); both kinds share the slots, the deadline expiry, and
    the launch policy."""

    rid: object
    model: str
    packed: object                       # PackedHistory | TxnGraph
    bucket: object                       # Bucket | TxnBucket | None
    t_in: float
    t_dead: Optional[float] = None
    ctx: object = None
    kind: str = "check"
    realtime: bool = False
    #: this request's launch budget: the latest instant its bucket
    #: may keep holding the batch open for it (deadline-derived;
    #: fill-window-capped) — the slot launches at the min over items
    t_budget: float = 0.0
    #: shrink only: when the job last re-queued (inter-round waits
    #: accumulate into queue_wait so stages keep tiling the wall)
    t_requeue: Optional[float] = None
    #: per-request stage attribution (STAGES keys, milliseconds) —
    #: filled along the dispatch path, echoed in the reply and fed to
    #: the stage histograms
    stages: dict = field(default_factory=dict)


@dataclass
class _Slot:
    """One bucket's forming batch (the continuous-batching admission
    unit): requests append as they arrive; ``t_launch`` is the min of
    their launch budgets."""

    items: List[PendingRequest] = field(default_factory=list)
    t_launch: float = float("inf")


def _not_ready() -> bool:
    """A staged dispatch with no event to poll finishes by the ring's
    rules alone."""
    return False


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[i]


@dataclass
class _BucketStats:
    requests: int = 0
    dispatches: int = 0
    batched: int = 0          # live (non-padding) requests dispatched
    compiles: int = 0         # first sighting of a program key
    occupancy_sum: float = 0.0  # live/B_prog per dispatch
    shard_fill_sum: float = 0.0  # occupied shard slots / D per dispatch
    device_s: float = 0.0
    programs: set = field(default_factory=set)


class VerifierCore:
    """See module docstring. All times are monotonic-clock floats
    (``obs.trace.monotonic`` — the pipeline's one clock) passed in by
    the caller — the daemon owns the clock so tests can drive launch
    budgets and deadlines deterministically."""

    def __init__(self, model: str = "cas-register",
                 engine: str = "auto", F: int = 1024,
                 batch_cap: int = 64, max_queue: int = 256,
                 limits: Optional[ServiceLimits] = None,
                 max_host_configs: int = 1 << 20,
                 shards: int = 1,
                 fill_window_s: float = DEFAULT_FILL_WINDOW_S,
                 ring_depth: int = DEFAULT_RING_DEPTH,
                 max_sessions: int = 64,
                 session_idle_s: float = 300.0,
                 device=None):
        from ..models.model import MODELS

        if model not in MODELS:
            raise ValueError(f"unknown model {model!r}")
        #: where every kind runs (``None`` means ``cuda``: no card
        #: raises here, before any request is admitted)
        self.device = resolve_device(device)
        self.model = model
        self.engine = engine
        self.F = F
        self.batch_cap = batch_cap
        self.max_queue = max_queue
        self.limits = limits or ServiceLimits()
        self.max_host_configs = max_host_configs
        self.fill_window_s = max(float(fill_window_s), 0.0)
        if ring_depth < 1:
            raise ValueError(f"ring_depth={ring_depth} must be >= 1")
        self.ring_depth = int(ring_depth)
        # shard-placement axis: every bucket dispatch fills D shard
        # slots (batch axis padded to a pow2 multiple of D) and rides
        # the mesh routes, one launch per device. D=1 is the plain
        # single-device path — no mesh is ever built.
        from .sharding import MAX_SHARDS, make_mesh

        self.shards = max(int(shards), 1)
        if self.shards > MAX_SHARDS:
            raise ValueError(
                f"shards={shards} exceeds the declared shard-axis "
                f"ceiling MAX_SHARDS={MAX_SHARDS}")
        if self.shards & (self.shards - 1):
            # fail at STARTUP: the engines reject non-pow2 meshes per
            # dispatch, which the pump's blanket except would turn
            # into 100% unknown replies on a daemon that looked ready
            raise ValueError(
                f"shards={shards} must be a power of two — per-shard "
                "shapes are bucket/D and must stay pow2")
        self.mesh = (make_mesh(self.shards, device=self.device.type)
                     if self.shards > 1 else None)
        # streaming sessions (kind:"stream", docs/streaming.md): one
        # device-resident carry per monitored live history; the table
        # is capped (a carry is real device memory) and idle sessions
        # evict on the pump beat
        from ..stream.manager import SessionManager

        self.sessions = SessionManager(max_sessions=max_sessions,
                                       idle_s=session_idle_s,
                                       device=self.device)
        #: drain mode (docs/service.md "Elastic fleet"): a
        #: draining core re-routes forming batches (queued requests
        #: answer ``shutting-down``), finalizes staged dispatches
        #: normally, sheds NEW work, and keeps serving the session
        #: handoff verbs (checkpoint/poll/close) + metrics/status
        self.draining = False
        #: the fleet ring version this daemon last registered under
        #: (``sut/verifier.epoch`` in pmux; the daemon sets it) —
        #: scraped as the ``ring_epoch`` gauge so a fleet-wide scrape
        #: shows membership convergence
        self.ring_epoch = 0
        self.t_boot = obs.monotonic()
        # continuous-batching admission state
        self._slots: Dict[tuple, _Slot] = {}
        self._hosts: deque = deque()     # out-of-bucket degradations
        self._jobs: deque = deque()      # shrink jobs (step per pump)
        self._ring: deque = deque()      # staged finish() callables
        self._done: List[Tuple[PendingRequest, dict]] = []
        self._programs: set = set()
        self._latencies: deque = deque(maxlen=2048)
        self._buckets: Dict[str, _BucketStats] = {}
        #: completion timestamps for the drain-rate estimate behind
        #: the overload retry_after_ms hint
        self._drain_win: deque = deque(maxlen=256)
        # the metrics plane (docs/observability.md): per-core registry
        # — histograms are fixed-bucket (quantiles without samples),
        # always on (a handful of integer adds per dispatch); span
        # TRACING is the separately-gated layer (obs.trace.enable)
        self.metrics = Registry()
        self._stage_h = {
            s: self.metrics.histogram(
                "service_" + s.replace("_ms", "") + "_ms")
            for s in STAGES}
        self._h_latency = self.metrics.histogram("service_latency_ms")
        self._g_queue = self.metrics.gauge("service_queue_depth")
        self._g_ring = self.metrics.gauge(
            "service_inflight_ring",
            help="staged dispatches in the in-flight ring "
                 "(staged/running/finalizing)")
        self._c_h2d = self.metrics.counter(
            "service_transfer_h2d_bytes_total",
            help="host->device bytes shipped per dispatch")
        self._c_d2h = self.metrics.counter(
            "service_transfer_d2h_bytes_total")
        # per-request rows + overload/deadline/degrade event marks for
        # the timeline SVG (report/service_svg.py); bounded deques —
        # rendering wants the recent window, not unbounded history
        self._timeline: deque = deque(maxlen=4096)
        self._events: deque = deque(maxlen=1024)
        self._priming = False
        self.m: Dict[str, int] = {
            "accepted": 0, "completed": 0, "overloads": 0,
            "bad_requests": 0, "malformed": 0, "deadline_expired": 0,
            "host_degraded": 0, "engine_errors": 0, "dispatches": 0,
            "compiles": 0, "program_hits": 0, "primed": 0,
            "shrink_requests": 0, "shrink_rounds": 0,
            # launch-reason counters: why each batch left its slot —
            # full (hit the cap at submit), deadline (oldest
            # request's launch budget expired), idle (wire went
            # quiet — the serial-caller path)
            "launch_full": 0, "launch_deadline": 0, "launch_idle": 0,
            # streaming sessions: opens/appends/closes + idle
            # evictions (docs/streaming.md)
            "stream_opens": 0, "stream_appends": 0,
            "stream_closes": 0, "stream_evicted": 0,
            # elastic fleet: checkpoint handoffs out
            # (verb:"checkpoint"), migrated sessions admitted in
            # (open-with-checkpoint), drain entries
            "stream_checkpoints": 0, "stream_migrations": 0,
            "drains": 0,
            # megabatched advances: fused calls that
            # carried >= 2 session lanes in one dispatch
            "stream_megabatches": 0,
            # workload-family checks admitted (kind:"wl",
            # docs/workloads.md) — they share accepted/completed/
            # dispatches with every other kind
            "wl_checks": 0,
            # staged dispatches finalized on the card because their
            # readback event polled done (CUDA only)
            "ring_polled": 0,
        }
        self._g_sessions = self.metrics.gauge(
            "stream_sessions_active",
            help="streaming sessions holding a device-resident carry")
        self._g_carry_bytes = self.metrics.gauge(
            "stream_carry_resident_bytes",
            help="device bytes held by resident session carries")
        # megabatch amortization plane (docs/streaming.md
        # "Megabatched advance"): how many session lanes each
        # launched stream program advanced (solo dispatches observe
        # 1), and the latest beat's fused lane count
        self._h_mb_lanes = self.metrics.histogram(
            "sessions_per_dispatch",
            help="session lanes advanced per launched stream "
                 "program",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0))
        self._g_mb_lanes = self.metrics.gauge(
            "stream_megabatch_lanes",
            help="session lanes riding fused megabatch programs in "
                 "the most recent stream batch")
        # elastic-fleet plane (docs/service.md "Elastic fleet"):
        # membership + migration visibility in every scrape
        self._g_epoch = self.metrics.gauge(
            "ring_epoch",
            help="fleet ring version this daemon last registered "
                 "under (bumped by every pmux join/leave)")
        self._c_migrations = self.metrics.counter(
            "stream_migrations",
            help="sessions admitted from a checkpoint handoff "
                 "(open-with-checkpoint)")
        self._c_ck_bytes = self.metrics.counter(
            "checkpoint_bytes",
            help="cumulative wire bytes of session checkpoints "
                 "handed off or admitted")

    # -- admission queue views -----------------------------------------

    def queue_depth(self) -> int:
        """Requests admitted but not yet dispatched (slot batches +
        host-route + shrink jobs) — the backpressure quantity."""
        return (sum(len(s.items) for s in self._slots.values())
                + len(self._hosts) + len(self._jobs))

    def inflight(self) -> int:
        """Staged dispatches in the in-flight ring."""
        return len(self._ring)

    @property
    def queue(self) -> List[PendingRequest]:
        """All queued requests in arrival order (tests/status; the
        hot path uses :meth:`queue_depth` / :meth:`_pending`)."""
        return sorted(self._pending(), key=lambda p: p.t_in)

    def next_event_at(self) -> Optional[float]:
        """Earliest instant scheduled work comes due (a slot's launch
        budget or a queued request's deadline) — the daemon sizes its
        select timeout with it. Runs every selector round: min over
        the raw collections, never the sorted ``queue`` view."""
        nxt = None
        for s in self._slots.values():
            if s.items and (nxt is None or s.t_launch < nxt):
                nxt = s.t_launch
        for p in self._pending():
            if p.t_dead is not None and (nxt is None
                                         or p.t_dead < nxt):
                nxt = p.t_dead
        return nxt

    def _pending(self):
        """Every queued request, unordered (the hot-path iterator
        behind :meth:`next_event_at`; ``queue`` is the sorted view)."""
        for s in self._slots.values():
            yield from s.items
        yield from self._hosts
        yield from self._jobs

    # -- admission -----------------------------------------------------

    def submit(self, req: dict, now: float, ctx: object = None):
        """Admit one ``check`` request. Returns ``(pending, reply)``:
        exactly one is non-None — an immediate ``reply`` (overload,
        bad-request, trivial, malformed, metrics) or a slotted
        ``pending``. A slot that reaches the batch cap launches its
        dispatch inside this call (continuous batching — replies
        surface at the next ``pump``)."""
        rid = req.get("id")
        if req.get("kind") == "metrics":
            # the scrape answers AHEAD of backpressure: the metrics
            # plane must work exactly when the queue is full — it
            # never queues, never dispatches
            return None, self.metrics_reply(rid)
        if req.get("kind") == "drain":
            return None, self._drain_verb(rid, now)
        if self.draining and not self._drain_serves(req):
            # a draining daemon re-routes instead of queueing: the
            # client's ring walk treats shutting-down like a dead
            # node and fails over — "forming batches re-route"
            out = protocol.error_reply(
                protocol.SHUTDOWN,
                "daemon is draining — re-route to the fleet", rid)
            out["draining"] = True
            return None, out
        if self.queue_depth() >= self.max_queue:
            # backpressure BEFORE parse: shedding load must stay O(1)
            # — and before the kind split, so txn requests answer
            # overload exactly like check requests. The reply carries
            # a retry_after_ms hint derived from queue depth and the
            # recent drain rate so clients back off proportionally.
            self.m["overloads"] += 1
            self._event("overload", now)
            ra = self._retry_after_ms(now)
            out = protocol.error_reply(
                protocol.OVERLOAD,
                f"admission queue at cap ({self.max_queue}); retry "
                f"in ~{ra} ms", rid)
            out["retry_after_ms"] = ra
            return None, out
        with obs.span("admission", rid=rid,
                      kind=req.get("kind", "check")):
            return self._admit(req, now, ctx, rid)

    #: completions older than this leave the drain-rate window — a
    #: rate spanning an idle gap would hint the 5 s clamp at the
    #: first overload after every quiet spell
    DRAIN_WINDOW_S = 10.0

    def _retry_after_ms(self, now: float) -> int:
        """Overload hint: the time the current backlog needs to drain
        at the RECENTLY observed completion rate (stale completions
        aged out), clamped to [25 ms, 5 s]. With no recent drain
        history, a few fill windows."""
        depth = self.queue_depth()
        win = self._drain_win
        cutoff = now - self.DRAIN_WINDOW_S
        while win and win[0] < cutoff:
            win.popleft()
        if len(win) >= 2 and now > win[0]:
            rate = (len(win) - 1) / (now - win[0])
            ms = depth / rate * 1e3 if rate > 0 else 5e3
        else:
            ms = max(4 * self.fill_window_s * 1e3, 100.0)
        return int(min(max(ms, 25.0), 5000.0))

    def _launch_budget(self, p: PendingRequest, now: float) -> float:
        """How long this request's slot may keep filling: the fill
        window, tightened by the deadline (half the headroom stays
        reserved for the dispatch itself — a request with 10 ms to
        live must not spend all 10 queued)."""
        if p.t_dead is None:
            return p.t_in + self.fill_window_s
        headroom = max(p.t_dead - now, 0.0)
        return p.t_in + min(self.fill_window_s,
                            headroom * LAUNCH_HEADROOM_FRACTION)

    def _slot_add(self, p: PendingRequest, now: float) -> None:
        key = ((p.kind, p.model, p.bucket) if p.kind == "check"
               else (p.kind, None, p.bucket))
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = _Slot()
        p.t_budget = self._launch_budget(p, now)
        slot.items.append(p)
        slot.t_launch = min(slot.t_launch, p.t_budget)
        if len(slot.items) >= self.batch_cap:
            # slot-filling dispatch: the batch is full NOW — launch
            # without waiting for the scheduler beat
            self._launch(key, "full")

    def _admit(self, req: dict, now: float, ctx: object, rid):
        """Parse/pack/bucket under the admission span (see submit)."""
        kind = req.get("kind", "check")
        if kind == "txn":
            return self._submit_txn(req, now, ctx, rid)
        if kind == "shrink":
            return self._submit_shrink(req, now, ctx, rid)
        if kind == "stream":
            return self._submit_stream(req, now, ctx, rid)
        if kind == "wl":
            return self._submit_wl(req, now, ctx, rid)
        if kind != "check":
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown kind {kind!r}", rid)
        model = req.get("model") or self.model
        from ..models.model import MODELS

        if model not in MODELS:
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown model {model!r}", rid)
        text = req.get("history")
        if not isinstance(text, str) or not text.strip():
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, "missing history (EDN text)", rid)
        try:
            ops = self._parse(text, model,
                              keyed=bool(req.get("keyed")))
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unparseable history: {e}", rid)
        try:
            packed = self._pack(ops)
        except (ValueError, RuntimeError) as e:
            # parsed but inconsistent (a double-pending process raises
            # RuntimeError in history.complete, bad op sequences raise
            # ValueError): the checker tri-state's honest answer
            self.m["malformed"] += 1
            return None, self._reply(rid, "unknown",
                                     cause=f"malformed: {e}")
        self.m["accepted"] += 1
        if packed is None:
            # no ok-completions: nothing ever constrains the frontier
            self.m["completed"] += 1
            return None, self._reply(rid, True, engine="trivial")
        try:
            bucket = bucket_for(packed, self.limits)
        except ValueError as e:
            self.m["malformed"] += 1
            return None, self._reply(rid, "unknown",
                                     cause=f"malformed: {e}")
        dl = req.get("deadline_ms")
        if dl is not None and not isinstance(dl, (int, float)):
            # one malformed field must stay THIS request's problem —
            # an exception here would tear down the shared daemon
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"deadline_ms must be a number, got {type(dl).__name__}",
                rid)
        pending = PendingRequest(
            rid=rid, model=model, packed=packed, bucket=bucket,
            t_in=now, ctx=ctx,
            t_dead=(now + float(dl) / 1e3) if dl is not None else None)
        if bucket is not None:
            self._bstats(bucket.key).requests += 1
            self._slot_add(pending, now)
        else:
            self._hosts.append(pending)
        return pending, None

    def _parse(self, text: str, model: str, keyed: bool):
        """EDN text -> Op list (parse failures are the CLIENT's bug —
        bad-request, never an unknown verdict)."""
        from ..ops.native_loader import parse_history_fast

        ops = parse_history_fast(text)
        if keyed or model == "cas-register-comdb2":
            from ..checker.independent import wrap_keyed_history

            ops = wrap_keyed_history(ops)
        return ops

    def _pack(self, ops):
        """Op list -> PackedHistory (None for trivially-valid)."""
        from ..ops.packed import pack_history

        if not ops or not any(op.type == "ok" for op in ops):
            return None
        return pack_history(list(ops))

    # -- txn-kind admission --------------------------------------------

    def _submit_txn(self, req: dict, now: float, ctx: object, rid):
        """Admit one serializability check. Same contract as the
        check kind: immediate reply for trivial/malformed, slotted
        PendingRequest otherwise — from here on the txn request rides
        the SAME launch policy, deadline expiry, and in-flight ring."""
        text = req.get("history")
        if not isinstance(text, str) or not text.strip():
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, "missing history (EDN text)", rid)
        try:
            # NEVER keyed-wrapped: txn values are micro-op vectors
            from ..ops.native_loader import parse_history_fast

            ops = parse_history_fast(text)
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unparseable history: {e}", rid)
        realtime = bool(req.get("realtime"))
        try:
            from ..txn import infer_edges

            graph = infer_edges(ops, realtime=realtime)
        except ValueError as e:
            self.m["malformed"] += 1
            return None, self._reply(rid, "unknown",
                                     cause=f"malformed: {e}")
        self.m["accepted"] += 1
        if not graph.adj.any():
            # edge-free graphs never cycle — but direct anomalies
            # (G1a, duplicates) still decide the verdict. Answered
            # BEFORE deadline_ms validation, matching the check
            # kind's trivial path (reply-parity contract)
            from ..txn import check_txn

            result = check_txn((), graph=graph, realtime=realtime,
                               device=self.device)
            self.m["completed"] += 1
            return None, self._txn_reply(rid, result, engine="trivial")
        dl = req.get("deadline_ms")
        if dl is not None and not isinstance(dl, (int, float)):
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"deadline_ms must be a number, got {type(dl).__name__}",
                rid)
        bucket = txn_bucket_for(graph.n, self.limits)
        pending = PendingRequest(
            rid=rid, model="txn", packed=graph, bucket=bucket,
            t_in=now, ctx=ctx, kind="txn", realtime=realtime,
            t_dead=(now + float(dl) / 1e3) if dl is not None else None)
        if bucket is not None:
            self._bstats(bucket.key).requests += 1
            self._slot_add(pending, now)
        else:
            self._hosts.append(pending)
        return pending, None

    # -- wl-kind admission ---------------------------------------------

    def _submit_wl(self, req: dict, now: float, ctx: object, rid):
        """Admit one workload-family check (docs/workloads.md):
        bank / sets / dirty-reads need no frontier search, so a
        history is a handful of column planes and a whole bucket's
        batch is ONE device call. From here the request rides the SAME
        continuous-batching machinery as every kind — bucket slot,
        launch policy, deadline expiry, in-flight ring; over-rung
        histories degrade to the host oracle one at a time."""
        from ..checker.wl import FAMILIES

        family = req.get("family")
        if family not in FAMILIES:
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"unknown wl family {family!r} (one of "
                f"{'/'.join(FAMILIES)})", rid)
        wlmodel = req.get("wl")
        if family == "bank" and (
                not isinstance(wlmodel, dict) or "n" not in wlmodel
                or "total" not in wlmodel):
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                "bank needs wl: {'n':..,'total':..}", rid)
        text = req.get("history")
        if not isinstance(text, str) or not text.strip():
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, "missing history (EDN text)", rid)
        try:
            # never keyed-wrapped: wl values are balances/sets, and a
            # bare [k v] read would mis-parse as a cas pair
            from ..ops.native_loader import parse_history_fast

            ops = parse_history_fast(text)
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unparseable history: {e}", rid)
        dl = req.get("deadline_ms")
        if dl is not None and not isinstance(dl, (int, float)):
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"deadline_ms must be a number, got {type(dl).__name__}",
                rid)
        try:
            bucket = wl_bucket_for(family, ops, wlmodel)
        except (ValueError, TypeError) as e:
            self.m["malformed"] += 1
            return None, self._reply(rid, "unknown", kind="wl",
                                     family=family,
                                     cause=f"malformed: {e}")
        self.m["accepted"] += 1
        self.m["wl_checks"] += 1
        pending = PendingRequest(
            rid=rid, model=f"wl-{family}",
            packed=(family, wlmodel, ops), bucket=bucket,
            t_in=now, ctx=ctx, kind="wl",
            t_dead=(now + float(dl) / 1e3) if dl is not None else None)
        if bucket is not None:
            self._bstats(bucket.key).requests += 1
            self._slot_add(pending, now)
        else:
            self._hosts.append(pending)
        return pending, None

    def _wl_reply(self, rid, verdict: dict, family: str,
                  **extra) -> dict:
        """Compress one oracle-shaped wl verdict dict into a wire
        reply (the family fields ride along verbatim — golden parity
        means they are exactly the host checker's)."""
        out = self._reply(rid, verdict.get("valid?"), kind="wl",
                          family=family, **extra)
        for k, v in verdict.items():
            if k != "valid?":
                out.setdefault(k, v)
        return out

    # -- shrink-kind admission -----------------------------------------

    def _submit_shrink(self, req: dict, now: float, ctx: object, rid):
        """Admit one counterexample-minimization request. The job
        (a step-driven :class:`~comdb2_tpu.shrink.core.DdminEngine`)
        rides the SAME overload backpressure and deadline expiry as
        every other kind; each pump advances it one ddmin round —
        shrink rounds are just more pow2-bucketed batch traffic — and
        a deadline returns best-so-far flagged ``partial``."""
        txn = bool(req.get("txn"))
        text = req.get("history")
        if not isinstance(text, str) or not text.strip():
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, "missing history (EDN text)", rid)
        model = req.get("model") or self.model
        realtime = bool(req.get("realtime"))
        from ..models.model import MODELS

        if not txn and model not in MODELS:
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown model {model!r}", rid)
        dl = req.get("deadline_ms")
        if dl is not None and not isinstance(dl, (int, float)):
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"deadline_ms must be a number, got {type(dl).__name__}",
                rid)
        try:
            if txn:
                ops = self._parse(text, "txn", keyed=False)
            else:
                ops = self._parse(text, model,
                                  keyed=bool(req.get("keyed")))
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unparseable history: {e}", rid)
        # one ddmin round runs synchronously inside a pump: cap its
        # candidate budget so a pathological seed costs a bounded
        # number of dispatches per round instead of wedging every
        # other request past its deadline
        round_cap = max(2 * self.batch_cap, 8)
        try:
            if txn:
                from ..shrink import TxnShrinker

                job = TxnShrinker(ops, realtime=realtime,
                                  round_cap=round_cap,
                                  mesh=self.mesh, device=self.device)
            else:
                from ..shrink import Shrinker

                if not ops or not any(op.type == "ok" for op in ops):
                    # trivially VALID: nothing constrains the frontier
                    # — a shrink of it is a client error, answered
                    # without burning a round (seed-rejection contract)
                    self.m["bad_requests"] += 1
                    return None, protocol.error_reply(
                        protocol.BAD_REQUEST,
                        "seed verdict is True — only INVALID "
                        "histories shrink", rid)
                job = Shrinker(ops, MODELS[model](), F=self.F,
                               engine=self.engine,
                               max_batch=self.batch_cap,
                               round_cap=round_cap,
                               mesh=self.mesh, device=self.device)
        except (ValueError, RuntimeError) as e:
            # includes MemoOverflow and malformed histories: the
            # tri-state's honest answer, same as the check kind
            self.m["malformed"] += 1
            return None, self._reply(rid, "unknown", kind="shrink",
                                     cause=f"malformed: {e}")
        self.m["accepted"] += 1
        self.m["shrink_requests"] += 1
        pending = PendingRequest(
            rid=rid, model=model, packed=job, bucket=None,
            t_in=now, ctx=ctx, kind="shrink", realtime=realtime,
            t_dead=(now + float(dl) / 1e3) if dl is not None else None)
        self._jobs.append(pending)
        return pending, None

    def _shrink_reply(self, p: PendingRequest, job,
                      partial: bool = False, **extra) -> dict:
        """Wire reply for a finished (or deadline-cut) shrink job."""
        if job.error is not None:
            # seed was VALID/UNKNOWN: an error, not a loop — the
            # client gets the observed verdict in the message
            self.m["bad_requests"] += 1
            return protocol.error_reply(protocol.BAD_REQUEST,
                                        str(job.error), p.rid)
        r = job.result(partial=partial)
        from ..ops.history import history_to_edn

        out = self._reply(
            p.rid, r.valid, kind="shrink",
            seed_ops=r.seed_ops, minimal_ops=r.n_ops,
            rounds=r.rounds, candidates=r.candidates,
            dispatches=r.dispatches, one_minimal=r.one_minimal,
            partial=r.partial, **r.extra, **extra)
        if r.n_ops <= 2048:
            out["minimal_history"] = history_to_edn(r.ops)
        else:
            # a deadline-cut 100k-event best-so-far must not blow up
            # the reply framing; the caller re-submits with more time
            out["minimal_history_omitted"] = True
        return out

    def _txn_reply(self, rid, result: dict, **extra) -> dict:
        """Compress a check_txn result map into a wire reply."""
        cex = result.get("counterexample")
        out = self._reply(
            rid, result["valid?"], kind="txn",
            txn_count=result.get("txn-count", 0),
            anomalies=[a["name"] for a in result.get("anomalies", ())],
            **extra)
        if result.get("malformed-ops"):
            # the unknown tri-state always carries a cause
            out["malformed_ops"] = result["malformed-ops"]
            out.setdefault(
                "cause", f"malformed: {result['malformed-ops']} "
                         "unparseable txn op(s)")
        if cex:
            out["anomaly_class"] = cex["class"]
            # full decode capped: replies ride next to latency-
            # sensitive traffic, and a pathological cycle can span
            # the whole graph
            out["cycle"] = cex["cycle"][:16]
            out["cycle_len"] = len(cex["cycle"])
        return out

    # -- stream-kind admission -----------------------------------------

    def _submit_stream(self, req: dict, now: float, ctx: object, rid):
        """Admit one streaming-session verb (docs/streaming.md).
        ``open``/``poll``/``close`` answer immediately (no device
        dispatch is staged for them — close's final tail flush is the
        one bounded exception); ``append`` slots into the session's
        SHAPE-CLASS batch and rides the same launch policy, deadline
        expiry, and in-flight ring as every other kind."""
        from ..stream.manager import SessionLimit

        verb = req.get("verb", "append")
        if verb == "open" and req.get("checkpoint") is not None:
            # open-with-checkpoint: the migration handoff's second
            # half (docs/streaming.md "Checkpoint / migration") — a
            # session drained off another daemon resumes HERE with
            # its carry bits intact, zero replay
            return self._stream_open_restored(req["checkpoint"], now,
                                              rid)
        if verb == "open":
            model = req.get("model") or self.model
            from ..models.model import MODELS
            from ..stream.wl import WL_MODELS

            is_wl = model in WL_MODELS
            if not is_wl and model not in MODELS:
                self.m["bad_requests"] += 1
                return None, protocol.error_reply(
                    protocol.BAD_REQUEST, f"unknown model {model!r}",
                    rid)
            try:
                if is_wl:
                    # workload-family session (stream/wl.py): ``wl``
                    # carries the family params (bank n/total); same
                    # table, cap, eviction and checkpoint machinery
                    sid, s = self.sessions.open(
                        now, model=model, wl=req.get("wl"))
                else:
                    sid, s = self.sessions.open(
                        now, model=model,
                        engine=req.get("rung", "auto"),
                        max_states=self.max_host_configs)
            except SessionLimit as e:
                # a carry is device memory: the cap sheds exactly like
                # the admission queue, hint included
                self.m["overloads"] += 1
                self._event("overload", now)
                ra = self._retry_after_ms(now)
                out = protocol.error_reply(
                    protocol.OVERLOAD, f"{e}; retry in ~{ra} ms", rid)
                out["retry_after_ms"] = ra
                return None, out
            except (ValueError, TypeError) as e:
                # bad wl params (bank without n/total): the client's
                # bug, answered before any session exists
                self.m["bad_requests"] += 1
                return None, protocol.error_reply(
                    protocol.BAD_REQUEST, f"bad wl params: {e}", rid)
            if not is_wl:
                # wl deltas are never keyed-wrapped (a bare [k v]
                # read would mis-parse as a cas pair)
                s.keyed = (bool(req.get("keyed"))
                           or model == "cas-register-comdb2")
            self.m["stream_opens"] += 1
            return None, self._reply(rid, True, kind="stream",
                                     session=sid, model=model)
        sid = req.get("session")
        if verb == "checkpoint":
            # resolved BEFORE the transparent-restore get(): an
            # idle-evicted session's held host snapshot is the
            # requested artifact — restoring it just to re-snapshot
            # would replay the memo extend log on the drain path
            return None, self._stream_checkpoint(sid, req, rid)
        s = self.sessions.get(sid, now)
        if s is None:
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"unknown session {sid!r} (expired or never opened — "
                "re-open and replay)", rid)
        if verb == "poll":
            return None, self._stream_reply(rid, sid, s.poll())
        if verb == "close":
            out = self.sessions.close(sid)
            self.m["stream_closes"] += 1
            return None, self._stream_reply(rid, sid, out)
        if verb != "append":
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown stream verb {verb!r}",
                rid)
        text = req.get("history")
        if not isinstance(text, str) or not text.strip():
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, "missing history (EDN delta)",
                rid)
        try:
            ops = self._parse(text, s.model_name,
                              keyed=getattr(s, "keyed", False))
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unparseable delta: {e}", rid)
        self.m["accepted"] += 1
        self.m["stream_appends"] += 1
        if s.valid is not True:
            # the latch: answer without queueing a dispatch
            self.m["completed"] += 1
            out = self._stream_reply(rid, sid, s.poll())
            out["latched"] = True
            return None, out
        dl = req.get("deadline_ms")
        if dl is not None and not isinstance(dl, (int, float)):
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST,
                f"deadline_ms must be a number, got {type(dl).__name__}",
                rid)
        pending = PendingRequest(
            rid=rid, model=s.model_name, packed=(sid, s, ops),
            bucket=StreamBucket(s.shape_class), t_in=now, ctx=ctx,
            kind="stream",
            t_dead=(now + float(dl) / 1e3) if dl is not None else None)
        self._bstats(pending.bucket.key).requests += 1
        self._slot_add(pending, now)
        return pending, None

    def _stream_open_restored(self, ck_wire, now: float, rid):
        """Admit one migrated session from its wire checkpoint."""
        from ..stream import checkpoint as CKPT
        from ..stream.manager import SessionLimit

        try:
            ck = CKPT.from_wire(ck_wire)
            nbytes = CKPT.wire_nbytes(ck_wire)
        except Exception as e:              # noqa: BLE001 — client data
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"undecodable checkpoint: {e}",
                rid)
        try:
            sid, s = self.sessions.open_restored(now, ck)
        except SessionLimit as e:
            self.m["overloads"] += 1
            self._event("overload", now)
            ra = self._retry_after_ms(now)
            out = protocol.error_reply(
                protocol.OVERLOAD, f"{e}; retry in ~{ra} ms", rid)
            out["retry_after_ms"] = ra
            return None, out
        except (ValueError, KeyError, TypeError) as e:
            self.m["bad_requests"] += 1
            return None, protocol.error_reply(
                protocol.BAD_REQUEST, f"unrestorable checkpoint: {e}",
                rid)
        self.m["stream_opens"] += 1
        self.m["stream_migrations"] += 1
        self._c_migrations.inc()
        self._c_ck_bytes.inc(nbytes)
        out = self._stream_reply(rid, sid, s.poll())
        out["migrated"] = True
        out["checkpoint_bytes"] = nbytes
        return None, out

    def _stream_checkpoint(self, sid, req: dict, rid) -> dict:
        """``verb:"checkpoint"``: snapshot a session for handoff.
        ``release:true`` (the migration form) removes it — a handoff
        MOVES the session; both daemons serving it would double-serve
        its appends."""
        from ..stream import checkpoint as CKPT

        release = bool(req.get("release"))
        ck = self.sessions.checkpoint(sid)
        if ck is None:
            self.m["bad_requests"] += 1
            return protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown session {sid!r}", rid)
        try:
            wire = CKPT.to_wire(ck)
            nbytes = CKPT.wire_nbytes(wire)
        except Exception as e:              # noqa: BLE001
            # encode failed: the session MUST survive — releasing
            # first would complete the MOVE's destructive half with
            # the checkpoint never delivered
            self.m["engine_errors"] += 1
            return protocol.error_reply(
                protocol.BAD_REQUEST,
                f"checkpoint not wire-encodable: "
                f"{type(e).__name__}: {e}", rid)
        if release:
            # the snapshot is encoded and about to ship: complete the
            # move (both daemons serving one session would
            # double-serve its appends)
            self.sessions.drop(sid)
        self.m["stream_checkpoints"] += 1
        self._c_ck_bytes.inc(nbytes)
        out = self._reply(rid, ck["valid"], kind="stream",
                          session=sid, checkpoint=wire,
                          checkpoint_bytes=nbytes, released=release)
        return out

    def _stream_reply(self, rid, sid, verdict: dict) -> dict:
        out = self._reply(rid, verdict.get("valid"), kind="stream",
                          session=sid)
        for k, v in verdict.items():
            out.setdefault(k, v)
        return out

    def _dispatch_stream_begin(self, bucket: StreamBucket,
                               items: List[PendingRequest]):
        """Stage one shape-class batch of session appends: each
        session ingests its delta and parks its new segments in the
        beat's forming MEGABATCH (``stream.engine.MegaBatch``) — one
        flush advances every lane of a rung in one device call
        (docs/streaming.md "Megabatched advance");
        ``finish`` reads the verdicts back oldest-first. Same ring
        contract as :meth:`_dispatch_begin`. Deltas the fused entries
        can't lane (oversized, mid-batch growth replays) dispatch
        solo inside the same beat and count as 1-lane programs."""
        from ..stream import engine as _SE

        t0 = obs.monotonic()
        rids = [p.rid for p in items]
        for p in items:
            p.stages["queue_wait_ms"] = (t0 - p.t_in) * 1e3
        fins = []
        d0 = _SE.DISPATCHES
        coll = _SE.MegaBatch()
        with obs.span("stage", kind="stream", bucket=bucket.key,
                      b=len(items), rids=rids):
            for p in items:
                sid, s, ops = p.packed
                try:
                    fins.append(s.append_stage(ops, collector=coll))
                except Exception as e:          # noqa: BLE001
                    cause = f"engine: {type(e).__name__}: {e}"
                    fins.append(("err", cause))
            coll.flush()
        for c in coll.lane_counts:
            self._h_mb_lanes.observe(float(c))
        self._g_mb_lanes.set(float(coll.fused_lanes))
        self.m["stream_megabatches"] += coll.fused_launches
        t_staged = obs.monotonic()
        pack_ms = (t_staged - t0) * 1e3
        for p in items:
            p.stages["host_pack_ms"] = pack_ms

        def finish(done: list) -> None:
            t_fin = obs.monotonic()
            n_disp = _SE.DISPATCHES - d0
            t_done = obs.monotonic()
            bs = self._bstats(bucket.key)
            bs.dispatches += n_disp
            bs.batched += len(items)
            bs.device_s += (t_staged - t0) + (t_done - t_fin)
            self.m["dispatches"] += n_disp
            obs.record("device", t_staged, t_done, bucket=bucket.key,
                       engine="stream-session", rids=rids)
            with obs.span("finalize", kind="stream",
                          bucket=bucket.key, rids=rids):
                for p, fin in zip(items, fins):
                    sid, s, _ops = p.packed
                    if isinstance(fin, tuple):
                        self.m["engine_errors"] += 1
                        self._event("engine_error", obs.monotonic())
                        reply = self._reply(p.rid, "unknown",
                                            kind="stream",
                                            session=sid, cause=fin[1])
                    else:
                        try:
                            verdict = fin()
                        except Exception as e:  # noqa: BLE001
                            self.m["engine_errors"] += 1
                            verdict = {
                                "valid": "unknown",
                                "cause": f"engine: "
                                         f"{type(e).__name__}: {e}"}
                        reply = self._stream_reply(p.rid, sid,
                                                   verdict)
                        reply["batched"] = len(items)
                    p.stages["device_ms"] = (t_done - t_staged) * 1e3
                    p.stages["finalize_ms"] = \
                        (obs.monotonic() - t_done) * 1e3
                    self._finish(p, reply, done)

        return finish

    # -- drain (elastic fleet, docs/service.md) ------------------------

    @staticmethod
    def _drain_serves(req: dict) -> bool:
        """What a draining core still answers: the session-handoff
        verbs (a departing daemon's whole point is letting clients
        pull their sessions out), plus poll/close. Everything else —
        new checks, txn, shrink, stream open/append — re-routes."""
        if req.get("kind") != "stream":
            return False
        return req.get("verb") in ("checkpoint", "poll", "close")

    def _drain_verb(self, rid, now: float) -> dict:
        """``kind:"drain"``: enter drain mode and report what's left.
        Idempotent — supervisors and SIGTERM both land here."""
        flushed = self.begin_drain(now)
        return {"ok": True, "kind": "drain", "draining": True,
                "flushed": flushed, "inflight": len(self._ring),
                "sessions": len(self.sessions),
                **({"id": rid} if rid is not None else {})}

    def begin_drain(self, now: float) -> int:
        """Enter drain: every QUEUED (not yet staged) request answers
        ``shutting-down`` so its client re-routes to the fleet —
        re-queueing them here would race the socket close. Staged
        dispatches in the in-flight ring are NOT touched: they
        finalize and reply normally (the pump drains the ring fully
        while draining). Sessions stay resident for checkpoint
        handoff. Returns the number of re-routed requests."""
        if not self.draining:
            self.draining = True
            self.m["drains"] += 1
            self._event("drain", now)
        flushed = 0
        for p in list(self._pending()):
            out = protocol.error_reply(
                protocol.SHUTDOWN,
                "daemon is draining — re-route to the fleet", p.rid)
            out["draining"] = True
            if p.kind == "stream":
                # the delta was never ingested; the session (and its
                # retained deltas client-side) are unchanged
                out["session"] = p.packed[0]
            self._finish(p, out, self._done)
            flushed += 1
        for slot in self._slots.values():
            slot.items = []
            slot.t_launch = float("inf")
        self._hosts.clear()
        self._jobs.clear()
        return flushed

    def drained(self) -> bool:
        """Nothing queued, nothing staged — the daemon may close once
        sessions are handed off (or its drain grace expires)."""
        return (self.draining and self.queue_depth() == 0
                and not self._ring)

    # -- the scheduler beat --------------------------------------------

    def pump(self, now: Optional[float] = None, idle: bool = False):
        """One scheduler beat: expire, launch due slots, run host
        degradations, advance shrink jobs, and return the completed
        ``[(pending, reply), ...]`` for the transport to fan out.
        ``idle=True`` means the wire went quiet — every non-empty slot
        launches (a lone serial caller never waits out the fill
        window) and the in-flight ring drains fully."""
        now = obs.monotonic() if now is None else now
        self._expire(now)
        # idle-session eviction on the scheduler beat: a carry nobody
        # appends to is device memory doing nothing — release it; the
        # client re-opens by replaying its retained deltas
        for _sid in self.sessions.evict_idle(now):
            self.m["stream_evicted"] += 1
            self._event("stream_evict", now)
        self._g_queue.set(self.queue_depth())
        for key in list(self._slots):
            slot = self._slots[key]
            if not slot.items:
                continue
            if len(slot.items) >= self.batch_cap:
                self._launch(key, "full")
            elif now >= slot.t_launch:
                self._launch(key, "deadline")
            elif idle:
                self._launch(key, "idle")
        while self._hosts:
            p = self._hosts.popleft()
            if p.kind == "txn":
                self._host_check_txn(p, self._done)
            elif p.kind == "wl":
                self._host_check_wl(p, self._done)
            else:
                self._host_check(p, self._done)
        self._step_shrinks()
        if self.device.type == "cuda":
            # a staged dispatch whose results are already on the host
            # finishes now, not when the ring overflows or drains; on
            # the CPU the ring keeps the JAX package's rules
            while self._ring and getattr(self._ring[0], "ready",
                                         _not_ready)():
                self.m["ring_polled"] += 1
                self._ring_pop()
        if idle or self.draining:
            self._ring_drain()
        elif self._ring and not any(s.items
                                    for s in self._slots.values()):
            # nothing is forming, so there is no batch left to
            # overlap against — finalize ONE staged dispatch per busy
            # beat. Non-queuing traffic (status/ping/metrics polls)
            # keeps got_bytes true forever, so idle rounds alone must
            # not be the only drain trigger; popping one entry bounds
            # a launched request's reply deferral without stalling
            # admission reads behind a full ring drain
            self._ring_pop()
        done, self._done = self._done, []
        return done

    def tick(self, now: Optional[float] = None):
        """The flush form of :meth:`pump` (idle semantics): launch
        everything queued, drain the ring, return the replies —
        priming, daemon shutdown and the unit tests drive it."""
        return self.pump(now, idle=True)

    def _step_shrinks(self) -> None:
        """Advance every queued shrink job ONE candidate-capped ddmin
        round (bounded dispatches per round via ``round_cap`` — long
        minimizations interleave with serving traffic instead of
        wedging the single-threaded loop) and re-queue the unfinished
        ones."""
        jobs, self._jobs = list(self._jobs), deque()
        for p in jobs:
            job = p.packed
            t_s0 = obs.monotonic()
            # first round pins the queue wait; later rounds charge the
            # inter-round re-queue wait to queue_wait (so stages keep
            # tiling the wall) and pure engine time to the device stage
            if "queue_wait_ms" not in p.stages:
                p.stages["queue_wait_ms"] = (t_s0 - p.t_in) * 1e3
            elif p.t_requeue is not None:
                p.stages["queue_wait_ms"] += \
                    (t_s0 - p.t_requeue) * 1e3
            try:
                with obs.span("shrink.round", rid=p.rid):
                    finished = job.step()
            except Exception as e:              # noqa: BLE001
                self.m["engine_errors"] += 1
                self._event("engine_error", obs.monotonic())
                self._finish(p, self._reply(
                    p.rid, "unknown", kind="shrink",
                    cause=f"engine: {type(e).__name__}: {e}"),
                    self._done)
                continue
            self.m["shrink_rounds"] += 1
            p.stages["device_ms"] = (
                p.stages.get("device_ms", 0.0)
                + (obs.monotonic() - t_s0) * 1e3)
            if finished:
                self._finish(p, self._shrink_reply(p, job), self._done)
            else:
                p.t_requeue = obs.monotonic()
                self._jobs.append(p)

    def _expire(self, now: float) -> None:
        """Answer every deadline-passed queued request ``unknown``
        (shrink: best-so-far ``partial``). An expired check/txn
        request never reached a dispatch: its whole wait IS queue
        wait — exactly the tail the latency histogram must explain
        (the remaining stages observe as 0, keeping the histogram
        counts tiled). A re-queued shrink job already pinned its real
        queue wait on the first round."""
        if self.queue_depth() == 0:
            return

        def expired(p):
            return p.t_dead is not None and now >= p.t_dead

        for slot in self._slots.values():
            if not any(expired(p) for p in slot.items):
                continue
            live = []
            for p in slot.items:
                if expired(p):
                    self._expire_one(p, now)
                else:
                    live.append(p)
            slot.items = live
            slot.t_launch = min((p.t_budget for p in live),
                                default=float("inf"))
        for q in (self._hosts, self._jobs):
            if not any(expired(p) for p in q):
                continue
            live = deque()
            for p in q:
                if expired(p):
                    self._expire_one(p, now)
                else:
                    live.append(p)
            q.clear()
            q.extend(live)

    def _expire_one(self, p: PendingRequest, now: float) -> None:
        self.m["deadline_expired"] += 1
        self._event("deadline", now)
        if "queue_wait_ms" not in p.stages:
            p.stages["queue_wait_ms"] = (now - p.t_in) * 1e3
        elif p.t_requeue is not None:
            # a shrink job expiring BETWEEN rounds: its final
            # re-queue wait is queue wait too, or sum(stages) stops
            # tiling the partial reply's latency
            p.stages["queue_wait_ms"] += (now - p.t_requeue) * 1e3
            p.t_requeue = None
        if p.kind == "shrink":
            # deadline returns BEST-SO-FAR, flagged partial — a
            # half-finished minimization is still a smaller repro
            # than the seed (seed-rejection errors keep their error
            # reply)
            self._finish(p, self._shrink_reply(
                p, p.packed, partial=True, cause="deadline"),
                self._done)
            return
        extra = {"kind": "txn"} if p.kind == "txn" else {}
        if p.kind == "wl":
            extra = {"kind": "wl", "family": p.packed[0]}
        if p.kind == "stream":
            # the delta was never ingested: the session is unchanged
            # and the client may retry the same append
            extra = {"kind": "stream", "session": p.packed[0]}
        self._finish(p, self._reply(p.rid, "unknown",
                                    cause="deadline", **extra),
                     self._done)

    # -- launch + the in-flight ring -----------------------------------

    def _launch(self, key: tuple, reason: str) -> None:
        """Move one slot's batch into the in-flight ring: stage the
        device dispatch(es) now, finalize when the ring overflows or
        drains — between the two, the device runs while the host packs
        the next batch (the PR-4 seam, ring-deep)."""
        slot = self._slots[key]
        items, slot.items = slot.items, []
        slot.t_launch = float("inf")
        if not items:
            return
        self.m["launch_" + reason] += 1
        kind, model, bucket = key
        for i in range(0, len(items), self.batch_cap):
            chunk = items[i:i + self.batch_cap]
            if kind == "txn":
                fin = self._dispatch_txn_begin(bucket, chunk)
            elif kind == "stream":
                fin = self._dispatch_stream_begin(bucket, chunk)
            elif kind == "wl":
                fin = self._dispatch_wl_begin(bucket, chunk)
            else:
                fin = self._dispatch_begin(model, bucket, chunk)
            self._ring_push(fin)

    def _ring_push(self, fin) -> None:
        while len(self._ring) >= self.ring_depth:
            self._ring_pop()
        self._ring.append(fin)
        self._g_ring.set(len(self._ring))

    def _ring_pop(self) -> None:
        fin = self._ring.popleft()
        self._g_ring.set(len(self._ring))
        fin(self._done)

    def _ring_drain(self) -> None:
        while self._ring:
            self._ring_pop()

    def _dispatch(self, model_name: str, bucket: Bucket,
                  items: List[PendingRequest], done: list) -> None:
        """Stage + finalize in one step (priming and direct callers;
        serving traffic rides the ring via :meth:`_launch`)."""
        self._dispatch_begin(model_name, bucket, items)(done)

    def _dispatch_begin(self, model_name: str, bucket: Bucket,
                        items: List[PendingRequest]):
        """Stage ONE device dispatch for a bucket's chunk and return a
        ``finish(done)`` callable: the segment axes are floored to the
        bucket, and the batch axis is pow2-padded with copies of the
        first history, as in the JAX package. On the stream engine the
        kernel runs between stage and finish — the ring stages other
        buckets' host packing in that window; torch's caching allocator
        reuses the per-dispatch buffers (no carry pool)."""
        from ..checker.batch import check_batch_async, pack_batch
        from ..models.memo import MemoOverflow
        from ..models.model import MODELS

        t0 = obs.monotonic()
        rids = [p.rid for p in items]
        for p in items:
            p.stages["queue_wait_ms"] = (t0 - p.t_in) * 1e3
        packeds = [p.packed for p in items]
        # the batch axis fills D shard slots per dispatch: pow2 AND a
        # multiple of the shard count, so every shard compiles the
        # same per-shard program (b_prog/D) and no dispatch leaves a
        # shard slot shapeless
        b_prog = max(_next_pow2(len(packeds)), self.shards)
        packeds = packeds + [packeds[0]] * (b_prog - len(packeds))
        info: dict = {}
        try:
            with obs.span("stage", kind="check", bucket=bucket.key,
                          b=len(items), b_prog=b_prog, rids=rids):
                batch = pack_batch(packeds, MODELS[model_name](),
                                   n_pad=bucket.n_pad)
                ns = _next_pow2(batch.memo.n_states)
                nt = _next_pow2(batch.memo.n_transitions)
                fin = check_batch_async(
                    batch, F=self.F, engine=self.engine, info=info,
                    mesh=self.mesh, device=self.device,
                    s_pad=bucket.S, k_pad=bucket.K,
                    n_states_pad=ns, n_transitions_pad=nt,
                    p_eff_pad=bucket.P_eff)
        except MemoOverflow as e:
            cause = f"memo overflow: {e}"
            return lambda done: self._fail_batch(items, bucket, cause,
                                                 done)
        except Exception as e:                  # noqa: BLE001
            # an engine blowup degrades THIS chunk to unknown; the
            # daemon must keep serving other buckets
            cause = f"{type(e).__name__}: {e}"
            return lambda done: self._fail_batch(items, bucket, cause,
                                                 done)

        t_staged = obs.monotonic()
        pack_ms = (t_staged - t0) * 1e3
        for p in items:
            p.stages["host_pack_ms"] = pack_ms

        def finish(done: list) -> None:
            t_fin = obs.monotonic()
            try:
                status, fail_at, n_final = fin()
            except Exception as e:              # noqa: BLE001
                self._fail_batch(items, bucket,
                                 f"{type(e).__name__}: {e}", done)
                return
            t_done = obs.monotonic()
            eng = info.get("engine", self.engine)
            xfer = info.get("transfer_bytes") or {}
            self._account_dispatch(bucket.key, t_staged, t_done,
                                   eng, xfer, rids)
            pk = (model_name, bucket.key, b_prog, ns, nt, self.F, eng)
            bs = self._bstats(bucket.key)
            bs.dispatches += 1
            bs.batched += len(items)
            bs.occupancy_sum += len(items) / b_prog
            if self.shards > 1:
                from .sharding import shard_fill

                fills = shard_fill(len(items), b_prog, self.shards)
                bs.shard_fill_sum += (
                    sum(1 for f in fills if f > 0) / self.shards)
            # stage duration + finalize wait for THIS dispatch only:
            # under the ring, wall time between stage and finish
            # belongs to OTHER buckets' host packs and must not
            # inflate this bucket's device seconds
            bs.device_s += (t_staged - t0) + (t_done - t_fin)
            if pk in self._programs:
                self.m["program_hits"] += 1
            else:
                self._programs.add(pk)
                bs.compiles += 1
                self.m["compiles"] += 1
            bs.programs.add(pk)
            self.m["dispatches"] += 1
            with obs.span("finalize", bucket=bucket.key, rids=rids):
                for i, p in enumerate(items):
                    p.stages["device_ms"] = (t_done - t_staged) * 1e3
                    p.stages["finalize_ms"] = \
                        (obs.monotonic() - t_done) * 1e3
                    self._finish(p, self._reply(
                        p.rid, protocol.verdict(status[i]),
                        op_index=int(fail_at[i]),
                        final_count=int(n_final[i]),
                        engine=eng, bucket=bucket.key,
                        batched=len(items)), done)

        if hasattr(fin, "ready"):
            finish.ready = fin.ready
        return finish

    def _account_dispatch(self, bucket_key: str, t_staged: float,
                          t_done: float, engine: str, xfer: dict,
                          rids: list) -> None:
        """Per-dispatch device window: the span (retroactive — the
        device ran asynchronously since stage time) and the
        host<->device transfer-byte counters. The device stage is
        dispatch->readback-complete: it includes the async overlap
        window the ring creates, which is exactly what a request WAITS
        on (the per-dispatch compute-only seconds stay in the bucket's
        ``device_s``; the per-REQUEST stage histograms observe at reply
        time in ``_finish``)."""
        h2d, d2h = int(xfer.get("h2d", 0)), int(xfer.get("d2h", 0))
        obs.record("device", t_staged, t_done, bucket=bucket_key,
                   engine=engine, bytes_h2d=h2d, bytes_d2h=d2h,
                   rids=rids)
        if not self._priming:
            self._c_h2d.inc(h2d)
            self._c_d2h.inc(d2h)

    def _fail_batch(self, items, bucket, cause, done) -> None:
        self.m["engine_errors"] += 1
        self._event("engine_error", obs.monotonic())
        for p in items:
            self._finish(p, self._reply(p.rid, "unknown",
                                        cause=f"engine: {cause}",
                                        bucket=bucket.key), done)

    def _dispatch_wl_begin(self, bucket: WlBucket,
                           items: List[PendingRequest]):
        """Stage one wl-family bucket chunk: encode the column planes
        and launch ONE device program (``stage_wl_batch``'s finalize
        is the readback point) — same ring contract as
        :meth:`_dispatch_begin`. The bucket's sig pins the padded
        per-history axes and its ``model_key`` pinned the slot, so
        every item shares one encode model; the batch axis pow2-pads
        inside the stage by duplicating lane 0."""
        from ..checker.wl import batch as WLB

        t0 = obs.monotonic()
        rids = [p.rid for p in items]
        for p in items:
            p.stages["queue_wait_ms"] = (t0 - p.t_in) * 1e3
        family = bucket.family
        wlmodel = items[0].packed[1]
        hists = [p.packed[2] for p in items]
        d0 = WLB.DISPATCHES
        try:
            with obs.span("stage", kind="wl", bucket=bucket.key,
                          b=len(items), rids=rids):
                fin0 = WLB.stage_wl_batch(hists, family, wlmodel,
                                          dims=wl_dims_of(bucket),
                                          device=self.device)
        except Exception as e:                  # noqa: BLE001
            cause = f"{type(e).__name__}: {e}"
            return lambda done: self._fail_batch(items, bucket, cause,
                                                 done)
        n_disp = WLB.DISPATCHES - d0
        bp = WLB.bucket_of(len(items), WLB.WL_BATCH)
        t_staged = obs.monotonic()
        pack_ms = (t_staged - t0) * 1e3
        for p in items:
            p.stages["host_pack_ms"] = pack_ms

        def finish(done: list) -> None:
            t_fin = obs.monotonic()
            try:
                verdicts = fin0()
            except Exception as e:              # noqa: BLE001
                self._fail_batch(items, bucket,
                                 f"{type(e).__name__}: {e}", done)
                return
            t_done = obs.monotonic()
            # n_disp == 0 means the stage degraded the whole chunk to
            # the host oracle (encode-time overflow) — the verdicts
            # carry engine:"host" and no program accounting applies
            eng = ("wl-device" if n_disp
                   else verdicts[0].get("engine", "host"))
            if not n_disp:
                self.m["host_degraded"] += len(items)
            self._account_dispatch(bucket.key, t_staged, t_done, eng,
                                   {}, rids)
            bs = self._bstats(bucket.key)
            bs.dispatches += n_disp
            bs.batched += len(items)
            if n_disp:
                bs.occupancy_sum += len(items) / bp
                pk = ("wl", bucket.key, bp)
                if pk in self._programs:
                    self.m["program_hits"] += 1
                else:
                    self._programs.add(pk)
                    bs.compiles += 1
                    self.m["compiles"] += 1
                bs.programs.add(pk)
            bs.device_s += (t_staged - t0) + (t_done - t_fin)
            self.m["dispatches"] += n_disp
            with obs.span("finalize", kind="wl", bucket=bucket.key,
                          rids=rids):
                for p, v in zip(items, verdicts):
                    p.stages["device_ms"] = (t_done - t_staged) * 1e3
                    p.stages["finalize_ms"] = \
                        (obs.monotonic() - t_done) * 1e3
                    self._finish(p, self._wl_reply(
                        p.rid, v, family,
                        engine=v.get("engine", eng),
                        bucket=bucket.key, batched=len(items)), done)

        return finish

    def _dispatch_txn_begin(self, bucket: TxnBucket,
                            items: List[PendingRequest]):
        """Stage ONE device dispatch for a txn bucket's chunk (same
        ring contract as :meth:`_dispatch_begin`): every graph pads to
        the bucket's N, the batch axis pow2-pads with copies of the
        first adjacency, and the whole stack rides a single
        ``closure_diag_batch_async`` call (one call per device on a
        mesh), its diagonal read back behind a CUDA event.
        Mixed realtime flags coexist in one batch — a request without
        realtime edges simply ships an all-zero rt plane."""
        import numpy as np

        from ..txn.closure_torch import closure_diag_batch_async

        t0 = obs.monotonic()
        rids = [p.rid for p in items]
        for p in items:
            p.stages["queue_wait_ms"] = (t0 - p.t_in) * 1e3
        with obs.span("stage", kind="txn", bucket=bucket.key,
                      b=len(items), rids=rids):
            adjs = [p.packed.padded(bucket.N) for p in items]
            # same shard-slot fill as the check kind: D | b_prog, pow2
            b_prog = max(_next_pow2(len(adjs)), self.shards)
            adjs = adjs + [adjs[0]] * (b_prog - len(adjs))
            stacked = np.stack(adjs)
        try:
            fin = closure_diag_batch_async(stacked, mesh=self.mesh,
                                           device=self.device)
        except Exception as e:                  # noqa: BLE001
            cause = f"{type(e).__name__}: {e}"

            def fail(done: list) -> None:
                self.m["engine_errors"] += 1
                self._event("engine_error", obs.monotonic())
                for p in items:
                    self._finish(p, self._reply(
                        p.rid, "unknown", kind="txn",
                        cause=f"engine: {cause}",
                        bucket=bucket.key), done)

            return fail
        t_staged = obs.monotonic()
        pack_ms = (t_staged - t0) * 1e3
        h2d = int(stacked.nbytes)

        def finish(done: list) -> None:
            from ..txn.check import verdict_map
            from ..txn.counterexample import decode

            t_fin = obs.monotonic()
            try:
                diag = fin()
            except Exception as e:              # noqa: BLE001
                self.m["engine_errors"] += 1
                self._event("engine_error", obs.monotonic())
                for p in items:
                    self._finish(p, self._reply(
                        p.rid, "unknown", kind="txn",
                        cause=f"engine: {type(e).__name__}: {e}",
                        bucket=bucket.key), done)
                return
            t_done = obs.monotonic()
            self._account_dispatch(
                bucket.key, t_staged, t_done, "closure",
                {"h2d": h2d, "d2h": int(diag.nbytes)}, rids)
            pk = ("txn", bucket.key, b_prog)
            bs = self._bstats(bucket.key)
            bs.dispatches += 1
            bs.batched += len(items)
            bs.occupancy_sum += len(items) / b_prog
            if self.shards > 1:
                from .sharding import shard_fill

                fills = shard_fill(len(items), b_prog, self.shards)
                bs.shard_fill_sum += (
                    sum(1 for f in fills if f > 0) / self.shards)
            bs.device_s += (t_staged - t0) + (t_done - t_fin)
            if pk in self._programs:
                self.m["program_hits"] += 1
            else:
                self._programs.add(pk)
                bs.compiles += 1
                self.m["compiles"] += 1
            bs.programs.add(pk)
            self.m["dispatches"] += 1
            with obs.span("finalize", kind="txn", bucket=bucket.key,
                          rids=rids):
                for i, p in enumerate(items):
                    g = p.packed
                    cex = decode(g, diag[i][:, :g.n],
                                 realtime=p.realtime)
                    p.stages["host_pack_ms"] = pack_ms
                    p.stages["device_ms"] = (t_done - t_staged) * 1e3
                    p.stages["finalize_ms"] = \
                        (obs.monotonic() - t_done) * 1e3
                    self._finish(p, self._txn_reply(
                        p.rid, verdict_map(g, cex), engine="closure",
                        bucket=bucket.key, batched=len(items)), done)

        return finish

    def _host_check_txn(self, p: PendingRequest, done: list) -> None:
        """Over-limit txn graphs degrade to the host SCC engine, one
        request at a time — same contract as the linear host route."""
        from ..txn import check_txn

        self.m["host_degraded"] += 1
        t0 = self._degrade_begin(p)
        try:
            with obs.span("host_degrade", kind="txn", rid=p.rid):
                result = check_txn((), graph=p.packed, backend="host",
                                   realtime=p.realtime)
            reply = self._txn_reply(p.rid, result, engine="host",
                                    degraded=True)
        except Exception as e:                  # noqa: BLE001
            reply = self._reply(p.rid, "unknown", kind="txn",
                                cause=f"host engine: {e}",
                                engine="host", degraded=True)
        p.stages["device_ms"] = (obs.monotonic() - t0) * 1e3
        self._finish(p, reply, done)

    def _host_check(self, p: PendingRequest, done: list) -> None:
        """Out-of-bucket degradation: the host engine checks this one
        request alone (``max_host_configs``-bounded — blowups answer
        ``unknown``, they don't wedge the pump)."""
        from ..checker import linear
        from ..models.model import MODELS

        self.m["host_degraded"] += 1
        t0 = self._degrade_begin(p)
        try:
            with obs.span("host_degrade", kind="check", rid=p.rid):
                a = linear.analysis(
                    MODELS[p.model](), p.packed, backend="host",
                    max_host_configs=self.max_host_configs,
                    device=self.device)
            reply = self._reply(
                p.rid, a.valid,
                op_index=(-1 if a.op_index is None else a.op_index),
                engine="host", degraded=True)
        except Exception as e:                  # noqa: BLE001
            reply = self._reply(p.rid, "unknown",
                                cause=f"host engine: {e}",
                                engine="host", degraded=True)
        p.stages["device_ms"] = (obs.monotonic() - t0) * 1e3
        self._finish(p, reply, done)

    def _host_check_wl(self, p: PendingRequest, done: list) -> None:
        """Over-rung wl histories degrade to the demoted host oracle
        (checker/workloads.py), one request at a time — same contract
        as the linear/txn host routes."""
        from ..checker.wl.batch import _host_fallback

        self.m["host_degraded"] += 1
        t0 = self._degrade_begin(p)
        family, wlmodel, ops = p.packed
        try:
            with obs.span("host_degrade", kind="wl", rid=p.rid):
                v = _host_fallback([ops], family, wlmodel)[0]
            reply = self._wl_reply(p.rid, v, family, engine="host",
                                   degraded=True)
        except Exception as e:                  # noqa: BLE001
            reply = self._reply(p.rid, "unknown", kind="wl",
                                family=family,
                                cause=f"host engine: {e}",
                                engine="host", degraded=True)
        p.stages["device_ms"] = (obs.monotonic() - t0) * 1e3
        self._finish(p, reply, done)

    def _degrade_begin(self, p: PendingRequest) -> float:
        """Shared host-degrade stage bookkeeping: the engine run is
        attributed to the device stage (it is what the request waits
        on; the ``engine: "host"`` reply field disambiguates)."""
        t0 = obs.monotonic()
        p.stages["queue_wait_ms"] = (t0 - p.t_in) * 1e3
        self._event("host_degraded", t0)
        return t0

    # -- bookkeeping ---------------------------------------------------

    def _reply(self, rid, valid, **extra) -> dict:
        out = {"ok": True, "valid": valid, **extra}
        if rid is not None:
            out["id"] = rid
        return out

    def _finish(self, p: PendingRequest, reply: dict,
                done: list) -> None:
        now = obs.monotonic()
        lat_ms = (now - p.t_in) * 1e3
        reply.setdefault("latency_ms", round(lat_ms, 3))
        # absent stages observe as 0 so every stage histogram shares
        # the latency histogram's count and sum(stages) tiles
        # latency_ms on EVERY reply path — deadline expiries (pure
        # queue wait) included
        for s in STAGES:
            p.stages.setdefault(s, 0.0)
            self._observe(s, p.stages[s])
        # rounded ONCE, shared read-only by the reply, the timeline
        # row and the trace record (single-threaded core)
        stages = {k: round(v, 3) for k, v in p.stages.items()}
        reply.setdefault("stages", stages)
        self._latencies.append(lat_ms)
        self.m["completed"] += 1
        if not self._priming:
            self._h_latency.observe(lat_ms)
            self._drain_win.append(now)
            self._timeline.append({
                "t": round(p.t_in - self.t_boot, 4),
                "lat_ms": round(lat_ms, 3), "kind": p.kind,
                "valid": reply.get("valid"), "stages": stages})
        if obs.enabled():
            # one complete per-request row for the trace: admission
            # time to reply, rid-correlated, stage attribution in args
            obs.record("request", p.t_in, now, rid=p.rid,
                       kind=p.kind, valid=reply.get("valid"),
                       **stages)
        done.append((p, reply))

    def _observe(self, stage: str, ms: float) -> None:
        """Feed one stage histogram sample (priming traffic never
        pollutes the serving metrics)."""
        if not self._priming:
            self._stage_h[stage].observe(ms)

    def _event(self, kind: str, now: Optional[float] = None) -> None:
        if self._priming:
            return
        self._events.append({
            "t": round((obs.monotonic() if now is None else now)
                       - self.t_boot, 4),
            "event": kind})

    def timeline_records(self) -> Tuple[list, list]:
        """(per-request rows, event marks) for the timeline SVG."""
        return list(self._timeline), list(self._events)

    def _bstats(self, key: str) -> _BucketStats:
        bs = self._buckets.get(key)
        if bs is None:
            bs = self._buckets[key] = _BucketStats()
        return bs

    # -- warm-start ----------------------------------------------------

    def prime(self, specs=DEFAULT_PRIME, seed: int = 7) -> int:
        """Warm start: on the card, build both kernel libraries (a cold
        ``nvcc`` build takes seconds and must not land in a request's
        latency); then synthesize one history per spec and push it
        through the REAL dispatch path at B=1 and B=copies. Raises when
        a build fails or a priming dispatch does not answer with a
        verdict — a daemon whose kernels cannot run must not announce
        itself ready. Returns the number of priming dispatches."""
        import random

        from ..ops.packed import pack_history
        from ..ops.synth import register_history

        if self.device.type == "cuda":
            from ..kernels import build

            build.build_all()
            for name in build.SOURCES:
                build.load(name)
        n0 = self.m["dispatches"]
        sink: list = []
        self._priming = True       # priming must not pollute the
        try:                       # serving histograms/timeline
            for n_events, copies in specs:
                h = register_history(random.Random(seed), n_procs=3,
                                     n_events=n_events, p_info=0.0)
                packed = pack_history(h)
                bucket = bucket_for(packed, self.limits)
                if bucket is None:
                    continue
                now = obs.monotonic()
                items = [PendingRequest(rid=None, model=self.model,
                                        packed=packed, bucket=bucket,
                                        t_in=now)
                         for _ in range(max(1, copies))]
                for i in range(0, len(items), self.batch_cap):
                    self._dispatch(self.model, bucket,
                                   items[i:i + self.batch_cap], sink)
        finally:
            self._priming = False
        failed = [r for _, r in sink if r.get("valid") is not True]
        if failed:
            raise RuntimeError(f"priming dispatch failed: "
                               f"{failed[0].get('cause', failed[0])}")
        n = self.m["dispatches"] - n0
        self.m["primed"] += n
        # priming replies go nowhere: back their completion count and
        # latency samples out so the serving metrics stay honest
        self.m["completed"] -= len(sink)
        for _ in sink:
            if self._latencies:
                self._latencies.pop()
        return n

    # -- observability -------------------------------------------------

    def metrics_reply(self, rid=None) -> dict:
        """The ``kind:"metrics"`` scrape reply: the JSON snapshot AND
        the Prometheus text form in one frame (docs/service.md)."""
        self._sync_metrics()
        out = {"ok": True, "kind": "metrics",
               "metrics": self.metrics.snapshot(),
               "prometheus": self.metrics.render_prometheus()}
        if rid is not None:
            out["id"] = rid
        return out

    def _sync_metrics(self) -> None:
        """Mirror the scalar state into the registry at scrape time:
        the ``m`` counters (launch reasons included), queue depth,
        ring occupancy, per-bucket occupancy/shard_fill, and the
        process-global kernel counters of
        :mod:`..utils.compile_guard` (``nvcc`` builds, launches by
        kernel, variants launched), where the JAX package scrapes its
        lowering and Mosaic-build counters. ``service_carry_reuses_
        total`` stays in the scrape and reads 0: the port keeps no
        donated-carry pool (torch's caching allocator reuses the
        blocks)."""
        m = self.metrics
        self._g_queue.set(self.queue_depth())
        self._g_ring.set(len(self._ring))
        self._g_sessions.set(len(self.sessions))
        self._g_carry_bytes.set(self.sessions.carry_bytes())
        self._g_epoch.set(self.ring_epoch)
        m.gauge(
            "stream_checkpoints_held",
            help="evicted sessions resumable from a host checkpoint"
        ).set(self.sessions.checkpoint_count())
        m.counter("service_stream_restores_total").value = \
            self.sessions.restores
        for k, v in self.m.items():
            m.counter(f"service_{k}_total").value = v
        for key, bs in self._buckets.items():
            occ = (bs.occupancy_sum / bs.dispatches
                   if bs.dispatches else 0.0)
            m.gauge("service_bucket_occupancy",
                    bucket=key).set(round(occ, 4))
            m.gauge("service_bucket_requests", bucket=key) \
                .set(bs.requests)
            m.gauge("service_bucket_dispatches", bucket=key) \
                .set(bs.dispatches)
            if self.shards > 1:
                fill = (bs.shard_fill_sum / bs.dispatches
                        if bs.dispatches else 0.0)
                m.gauge("service_bucket_shard_fill",
                        bucket=key).set(round(fill, 4))
        from ..utils import compile_guard as CG

        m.counter("compile_kernel_builds_total",
                  help="nvcc builds of the kernel libraries").value = \
            CG.KERNEL_BUILDS
        for kern, n in CG.LAUNCHES.items():
            m.counter("compile_kernel_launches_total",
                      help="kernel launches on the card",
                      kernel=kern).value = n
        m.gauge("compile_kernel_variants",
                help="(kernel, layout) variants launched").set(
            len(CG.VARIANTS))
        m.counter("compile_kernel_card_seconds_total",
                  help="the card's seconds in the timed kernel "
                       "launches").value = CG.card_ms() / 1e3
        m.counter(
            "service_carry_reuses_total",
            help="stream-kernel carry buffers recycled on device "
                 "instead of re-uploaded (always 0 here: no carry "
                 "pool)").value = 0

    def status(self, now: Optional[float] = None) -> dict:
        from ..utils import compile_guard as CG

        now = obs.monotonic() if now is None else now
        lats = sorted(self._latencies)
        buckets = {}
        for key, bs in self._buckets.items():
            buckets[key] = {
                "requests": bs.requests,
                "dispatches": bs.dispatches,
                "batched": bs.batched,
                "compiles": bs.compiles,
                "programs": len(bs.programs),
                "occupancy": round(
                    bs.occupancy_sum / bs.dispatches, 4)
                if bs.dispatches else 0.0,
                "device_s": round(bs.device_s, 3),
            }
            if self.shards > 1:
                # fraction of the D shard slots holding at least one
                # live request, averaged over dispatches — the shard-
                # placement quality metric
                buckets[key]["shard_fill"] = round(
                    bs.shard_fill_sum / bs.dispatches, 4) \
                    if bs.dispatches else 0.0
        return {
            **self.m,
            "uptime_s": round(now - self.t_boot, 3),
            "queue_depth": self.queue_depth(),
            "inflight_ring": len(self._ring),
            "ring_depth": self.ring_depth,
            "fill_window_ms": round(self.fill_window_s * 1e3, 3),
            "carry_reuses": 0,
            "draining": self.draining,
            "ring_epoch": self.ring_epoch,
            "stream": {
                "sessions": len(self.sessions),
                "max_sessions": self.sessions.max_sessions,
                "carry_bytes": self.sessions.carry_bytes(),
                "idle_s": self.sessions.idle_s,
                "checkpoints_held": self.sessions.checkpoint_count(),
                "restores": self.sessions.restores,
            },
            "model": self.model,
            "engine": self.engine,
            "device": str(self.device),
            "shards": self.shards,
            "kernels": {"builds": CG.KERNEL_BUILDS,
                        "launches": dict(CG.LAUNCHES),
                        "variants": len(CG.VARIANTS),
                        "card_ms": CG.card_ms()},
            "frontier": self.F,
            "batch_cap": self.batch_cap,
            "max_queue": self.max_queue,
            "programs": len(self._programs),
            "latency_ms": {
                "p50": round(_percentile(lats, 0.50), 3),
                "p99": round(_percentile(lats, 0.99), 3),
                "n": len(lats),
            },
            # the stage-histogram quantiles ride the status artifact
            # (harness.store web status) so the p99/p50 gap is
            # attributable without a full metrics scrape
            "stage_ms": {
                s.replace("_ms", ""): {
                    "p50": round(h.quantile(0.50), 3),
                    "p95": round(h.quantile(0.95), 3),
                    "p99": round(h.quantile(0.99), 3),
                    "n": h.count,
                } for s, h in self._stage_h.items()},
            "transfer_bytes": {"h2d": self._c_h2d.value,
                               "d2h": self._c_d2h.value},
            "tracing": obs.enabled(),
            "buckets": buckets,
        }


__all__ = ["DEFAULT_FILL_WINDOW_S", "DEFAULT_PRIME",
           "DEFAULT_RING_DEPTH", "PendingRequest", "STAGES",
           "VerifierCore"]
