"""StreamSession — one monitored live history, one resident carry.

The counterpart of the JAX package's ``stream/session.py``. The
session composes the incremental layers into the streaming
verification loop:

    append(ops) -> ingest delta        (columnar, watermark-settled)
               -> extend memo          (state ids stable)
               -> segment + rename     (tail + renamer carried)
               -> dispatch NEW segments against the resident carry
               -> verdict-so-far       (latched once terminal)

Per-append device work is O(delta). The only O(history) events are
engine RE-ROUTES (kernel frontier overflow, MXU re-plan after table
or concurrency growth), which replay the session's retained renamed
segment stream onto a fresh rung.

Verdicts LATCH: linearizability of a prefix is monotone — once a
prefix is non-linearizable every extension is, so an INVALID (or a
terminal UNKNOWN) answers later appends immediately without touching
the device.

The session lives on ``device`` (``None`` means ``cuda``, which raises
on a host without a card; ``"cpu"`` runs every rung on CPU tensors,
the kernel rung as the kernel's plain version). An engine error —
on the card a missing ``nvcc``, a failed build or launch — latches the
session UNKNOWN with an ``engine:`` cause and then RAISES out of
``append``: it is never answered from another device.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..checker import linear_torch as LT
from ..checker import seg_kernel as SK
from ..models.memo import IncrementalMemo, MemoOverflow
from ..models.model import MODELS, Model
from ..obs import trace as _obs
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device
from . import engine as ENG
from .ingest import MalformedDelta, StreamIngest
from .segment import StreamSegmenter

VALID, INVALID, UNKNOWN = 0, 1, 2


def _even(p: int) -> int:
    p = max(p, 2)
    return p + (p & 1)


class StreamSession:
    """See module docstring. ``engine`` forces a rung ("kernel" /
    "mxu" / "xla"); "auto" follows ``analysis``'s ladder. ``max_states``
    caps the incremental memo (overflow latches UNKNOWN, the honest
    tri-state)."""

    def __init__(self, model: Union[str, Model] = "cas-register",
                 engine: str = "auto", max_states: int = 1 << 20,
                 device=None):
        self.device = resolve_device(device)
        if isinstance(model, str):
            if model not in MODELS:
                raise ValueError(f"unknown model {model!r}")
            self.model_name = model
            model = MODELS[model]()
        else:
            self.model_name = type(model).__name__
        self.engine_policy = engine
        self.ingest = StreamIngest()
        self.seg = StreamSegmenter()
        self.memo = IncrementalMemo(model, max_states=max_states)
        self._eng = None
        self._rung: Optional[str] = None
        self._succ_dev = None
        self._succ_key = None
        self._table_dev = None        # kernel rung's packed table
        self._table_key = None
        self.P2 = 2
        self.dispatched_segments = 0  # prefix already on the carry
        self.appends = 0
        self.dispatches = 0           # session-local delta dispatches
        self.replays = 0
        self.valid: Union[bool, str, None] = True
        self.cause: Optional[str] = None
        self.fail_index: int = -1
        self.final_count: int = 1
        self.engines_tried: List[dict] = []
        self.closed = False
        self._inflight = None

    # -- public API ----------------------------------------------------

    def append(self, ops) -> dict:
        """Ingest one delta, dispatch its new segments, return the
        verdict-so-far map (synchronous form)."""
        fin = self.append_stage(ops)
        return fin()

    def append_stage(self, ops, collector=None):
        """Stage one append (ingest + dispatch) and return a zero-arg
        finalize producing the verdict map — a caller serving many
        sessions overlaps other sessions' host work with this one's
        device run. Appends to one session serialize: staging while an
        earlier append is unfinalized finalizes it first.

        ``collector`` (an :class:`~.engine.MegaBatch`)
        parks this delta in the beat's forming megabatch instead of
        dispatching solo; the finalize flushes the collector before
        reading the carry, so callers may finalize in any order."""
        if self._inflight is not None:
            self._inflight()
        if self.closed:
            out = self._verdict_map()
            out["cause"] = "session closed"
            return lambda: out
        self.appends += 1
        if self._latched():
            # the latch: a non-linearizable prefix stays
            # non-linearizable under every extension — answer without
            # ingesting or touching the device
            out = self._verdict_map()
            out["latched"] = True
            return lambda: out
        try:
            with _obs.span("stream.ingest", n=len(ops)):
                lo, hi = self.ingest.append(list(ops))
        except MalformedDelta as e:
            self._latch_unknown(f"malformed: {e}")
            return lambda: self._verdict_map()
        return self._stage_settled(lo, hi, collector)

    def finalize_input(self) -> dict:
        """End of stream: settle the tail (open invokes keep their
        invoked values, one-shot parity) and dispatch whatever oks
        that unblocks. The final verdict and fail index are a one-shot
        ``check_batch``'s of the full history."""
        if self._inflight is not None:
            self._inflight()
        if self.closed or self._latched():
            return self._verdict_map()
        lo, hi = self.ingest.finalize()
        return self._stage_settled(lo, hi)()

    def poll(self) -> dict:
        if self._inflight is not None:
            self._inflight()
        return self._verdict_map()

    def close(self) -> dict:
        """Finalize, release the device carry, reject further work.
        The release rides ``finally``: a finalize that raises (engine
        error, rung re-route failure) must still free the carry, or
        the session leaks device memory until idle eviction."""
        try:
            out = self.finalize_input()
        finally:
            self.release()
        return out

    def release(self) -> None:
        """Drop the device carry WITHOUT the final tail settle — the
        eviction path. Forces any in-flight staged append through its
        (idempotent) finalize first, so a staged dispatch can never
        read a released engine."""
        if self._inflight is not None:
            self._inflight()
        self._eng = None
        self._succ_dev = None
        self._table_dev = None
        self.closed = True

    def carry_nbytes(self) -> int:
        return self._eng.nbytes() if self._eng is not None else 0

    @property
    def shape_class(self) -> str:
        """The session's shape class: rung, slot width, K bucket and
        table buckets — sessions of one class can share a megabatch
        group."""
        ns, nt = ENG.pad_sizes(max(self.memo.n_states, 1),
                               max(self.memo.n_transitions, 1))
        return (f"stream-{self._rung or 'new'}-p{self.P2}"
                f"-k{self._k_bucket()}-t{ns}x{nt}")

    # -- checkpoint / restore ------------------------------------------

    def checkpoint(self) -> dict:
        """Host-numpy snapshot of the whole session: the engine carry
        (the device-resident piece — O(carry)), the ingest watermark +
        columns, the segment tail + renamer + retained renamed stream,
        and the memo's extend log. Restoring from it resumes with the
        SAME state ids, segment coordinates and carry bits as the live
        session, on any device, so eviction and migration cost zero
        device replay. The layout is the JAX package's except the
        kernel rung's words (``convert.session_checkpoint`` carries
        that package's checkpoints over). Forces any staged append
        through its finalize first (a snapshot must never be
        mid-dispatch)."""
        if self._inflight is not None:
            self._inflight()
        return {
            "v": 1,
            "model": self.model_name,
            "engine_policy": self.engine_policy,
            "keyed": bool(getattr(self, "keyed", False)),
            "P2": int(self.P2),
            "rung": self._rung,
            "dispatched_segments": int(self.dispatched_segments),
            "appends": int(self.appends),
            "dispatches": int(self.dispatches),
            "replays": int(self.replays),
            "valid": self.valid,
            "cause": self.cause,
            "fail_index": int(self.fail_index),
            "final_count": int(self.final_count),
            "engines_tried": list(self.engines_tried),
            "closed": bool(self.closed),
            "memo": self.memo.checkpoint(),
            "ingest": self.ingest.checkpoint(),
            "seg": self.seg.checkpoint(),
            "eng": (self._eng.checkpoint()
                    if self._eng is not None else None),
        }

    @classmethod
    def restore(cls, ck: dict, device=None) -> "StreamSession":
        """Rebuild a session from :meth:`checkpoint` on ``device``.
        The memo replays its extend log (state ids bit-identical — the
        carry stores them) and the engine carry uploads as it was: no
        replay. There is no probe and no re-route: a kernel-rung
        session restored on the card launches the kernel, on the CPU
        its plain version."""
        if ck.get("v") != 1:
            raise ValueError(f"unknown checkpoint version {ck.get('v')!r}")
        model = ck["model"]
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r} in checkpoint")
        s = cls(model, engine=ck["engine_policy"],
                max_states=int(ck["memo"]["max_states"]), device=device)
        s.keyed = bool(ck["keyed"])
        s.memo = IncrementalMemo.restore(MODELS[model](), ck["memo"])
        from .ingest import StreamIngest as _SI
        from .segment import StreamSegmenter as _SS

        s.ingest = _SI.restore(ck["ingest"])
        s.seg = _SS.restore(ck["seg"])
        s.P2 = int(ck["P2"])
        s._rung = ck["rung"]
        s.dispatched_segments = int(ck["dispatched_segments"])
        s.appends = int(ck["appends"])
        s.dispatches = int(ck["dispatches"])
        s.replays = int(ck["replays"])
        s.valid = ck["valid"]
        s.cause = ck["cause"]
        s.fail_index = int(ck["fail_index"])
        s.final_count = int(ck["final_count"])
        s.engines_tried = list(ck["engines_tried"])
        s.closed = bool(ck["closed"])
        eng_ck = ck["eng"]
        if eng_ck is None:
            return s
        rung = eng_ck["rung"]
        if rung == "xla":
            s._eng = ENG.XlaCarry.restore(eng_ck, s.device)
        elif rung == "mxu":
            s._eng = ENG.MxuCarry.restore(eng_ck, s.device)
        else:
            spec = ENG.kernel_spec(int(eng_ck["ns"]),
                                   int(eng_ck["nt"]), s.P2,
                                   int(eng_ck["K"]))
            if spec is None:
                raise ValueError("kernel-rung checkpoint outside the "
                                 "kernel's shapes")
            s._eng = ENG.KernelCarry.restore(spec, eng_ck, s.device)
        return s

    def counterexample(self, F: int = 4096):
        """Bounded failing-config reconstruction on the retained
        columnar tables (the owner-map decode path — API edge), on the
        session's device."""
        if self.valid is not False:
            return None
        from ..checker import counterexample as CE

        packed = self.ingest.packed_history()
        return CE.reconstruct(self.memo.as_memoized(), packed,
                              F=max(256, min(F, 65536)),
                              device=self.device)

    # -- staging -------------------------------------------------------

    def _stage_settled(self, lo: int, hi: int, collector=None):
        try:
            self._extend_memo()
            with _obs.span("stream.segment", lo=lo, hi=hi):
                s_lo, s_hi = self.seg.feed(self.ingest, lo, hi)
        except MemoOverflow as e:
            self._latch_unknown(f"memo overflow: {e}")
            return lambda: self._verdict_map()
        except ValueError as e:
            self._latch_unknown(f"malformed: {e}")
            return lambda: self._verdict_map()
        if s_hi == s_lo:
            return lambda: self._verdict_map()
        if _even(self.seg.p_eff) > ENG.STREAM_MAX_P \
                or self._k_bucket() > ENG.STREAM_MAX_K:
            # past the declared stream-delta ladder there is no
            # program to run (and a genuinely concurrent P>32 closure
            # is a 2^P frontier nothing searches anyway): the honest
            # tri-state, latched — NOT an off-inventory compile per
            # growth step
            self._latch_unknown(
                f"concurrency beyond the stream ladder (P_eff="
                f"{self.seg.p_eff} > {ENG.STREAM_MAX_P} or K="
                f"{self.seg.k_max} > {ENG.STREAM_MAX_K})")
            return lambda: self._verdict_map()
        try:
            self._maintain_shapes()
            with _obs.span("stream.dispatch", s_lo=s_lo, s_hi=s_hi,
                           engine=self._rung):
                self._dispatch_range(s_lo, s_hi, collector)
        except Exception as e:
            # an engine error is an error, never a verdict: latch (no
            # later append may read this carry) and raise
            self._latch_unknown(f"engine: {type(e).__name__}: {e}")
            raise

        done: dict = {}

        def finalize():
            # idempotent: a caller may call every staged fin, but an
            # append staged AFTER this one already forced it through
            # the session's inflight serialization — a second
            # _finalize_range against the later delta's carry would
            # re-apply segments
            if "out" in done:
                return done["out"]
            self._inflight = None
            try:
                if collector is not None:
                    # the delta may still be parked in the beat's
                    # forming megabatch (a second append to this
                    # session forces THIS finalize before the
                    # caller's own flush) — drain it first, and
                    # skip the carry read when the flush latched us
                    # (a failed group call never ran this delta)
                    collector.flush()
                if not self._latched():
                    self._finalize_range(s_lo, s_hi)
            except Exception as e:
                self._latch_unknown(
                    f"engine: {type(e).__name__}: {e}")
                done["out"] = self._verdict_map()
                raise
            done["out"] = self._verdict_map()
            return done["out"]

        self._inflight = finalize
        return finalize

    # -- shape maintenance ---------------------------------------------

    def _k_bucket(self) -> int:
        return _next_pow2(self.seg.k_max, 2)

    def _extend_memo(self) -> None:
        known = self.memo.n_transitions
        new = self.ingest.transitions_of(known,
                                         len(self.ingest
                                             .transition_table))
        self.memo.extend(new, self.ingest.n_invokes_settled)

    def _maintain_shapes(self) -> None:
        """Grow-events between appends: concurrency (P_eff), table
        buckets, K. Rungs that absorb growth in place do (the kernel
        rung re-encodes its carry, the xla rung widens and retargets);
        the rest replay the retained segments onto a re-picked rung."""
        ns, nt = ENG.pad_sizes(max(self.memo.n_states, 1),
                               max(self.memo.n_transitions, 1))
        P2 = _even(self.seg.p_eff)
        K = self.seg.k_max
        if self._eng is None:
            self.P2 = P2
            self._rung = ENG.pick_rung(ns, nt, P2, K,
                                       self.engine_policy)
            self._eng = self._make_engine(self._rung, ns, nt, P2)
            return
        replay = False
        if P2 > self.P2:
            # concurrency growth can cross an engine crossover (the
            # kernel's P<=15 tiers, the MXU's P>=16 ownership) — a
            # rung change is a replay, widening in place is not
            preferred = self._pick(ns, nt, P2, K)
            if preferred != self._rung or (
                    self._rung != "kernel"
                    and not self._eng.widen_slots(P2)):
                replay = True
            self.P2 = P2
        if self._rung == "kernel":
            eng = self._eng
            if not replay and ((ns, nt, self.P2) != (eng.ns, eng.nt,
                                                     eng.spec.P)
                               or K > eng.spec.K):
                replay = not eng.respec(ns, nt, self.P2, K)
        elif (ns, nt) != self._eng_sizes():
            if not self._eng.rebucket(ns, nt):
                replay = True
        if replay:
            self._reroute(note="growth")

    def _eng_sizes(self):
        return self._eng.ns, self._eng.nt

    def _make_engine(self, rung: str, ns: int, nt: int, P2: int):
        dev = self.device
        if rung == "kernel":
            spec = ENG.kernel_spec(ns, nt, P2, self.seg.k_max)
            if spec is None:            # shape outgrew the kernel —
                # attributed, so a forced engine="kernel" caller can
                # see the substitution instead of silently measuring
                # the wrong rung
                self.engines_tried.append(
                    {"engine": "stream-kernel",
                     "note": "spec unavailable for shape",
                     "frontier_capacity": None})
                rung = ("mxu" if ENG.MXU.serves(ns, nt, P2)
                        else "xla")
                self._rung = rung
            else:
                self._table_dev = None
                return ENG.KernelCarry(spec, ns, nt, dev)
        if rung == "mxu":
            if ENG.MXU.serves(ns, nt, P2):
                return ENG.MxuCarry(ns, nt, P2, device=dev)
            # same attribution contract as the kernel branch: a
            # forced engine="mxu" caller must see the substitution
            self.engines_tried.append(
                {"engine": "stream-mxu",
                 "note": "engine does not serve this shape",
                 "frontier_capacity": None})
        self._rung = "xla"
        return ENG.XlaCarry(ns, nt, P2, device=dev)

    # -- dispatch ------------------------------------------------------

    def _succ_device(self):
        ns, nt = self._eng_sizes()
        key = (self.memo.version, ns, nt)
        if self._succ_key != key:
            self._succ_dev = torch.from_numpy(
                LT.pad_succ(self.memo.succ, ns, nt)).to(self.device)
            self._succ_key = key
            self._table_dev = None
        return self._succ_dev

    def _kernel_table(self):
        # keyed on memo.version: a new transition interned WITHIN the
        # same pow2 bucket changes table content without any shape
        # event, and a stale table would misdecode its successors.
        # The table packs the BUCKET-padded succ because the kernel's
        # runtime row stride is the rung's padded nt (KernelCarry
        # passes it to every launch) — packing the exact-width
        # memo.succ against a padded stride would misalign every
        # state>0 row.
        key = (self.memo.version, self._eng.ns, self._eng.nt)
        if self._table_dev is None or self._table_key != key:
            padded = LT.pad_succ(self.memo.succ, self._eng.ns,
                                 self._eng.nt)
            self._table_dev = torch.from_numpy(
                SK.pack_table(padded)).to(self.device)
            self._table_key = key
        return self._table_dev

    def _kernel_rows(self, s_lo: int, s_hi: int) -> np.ndarray:
        """Segments [s_lo, s_hi) as the kernel's int32[S, 2+2K] rows
        at the spec's K — exactly the delta's segments, no padding."""
        spec = self._eng.spec
        ip, it, okp, dp = self.seg.padded(s_lo, s_hi, s_hi - s_lo,
                                          spec.K)
        segs = LT.SegmentStream(ip, it, okp,
                                self.seg.seg_row.a[s_lo:s_hi], dp)
        return SK.pack_segments(segs, spec)

    def _dispatch_range(self, s_lo: int, s_hi: int,
                        collector=None) -> None:
        """Dispatch segments [s_lo, s_hi) against the resident carry
        (one pre-delta snapshot for the whole range — escalation
        re-runs the range). With a ``collector`` the delta joins the
        beat's forming megabatch instead (flushed before any joined
        finalize reads a carry); deltas that split dispatch solo."""
        self._eng.begin_delta()
        if collector is not None \
                and self._megabatch_join(collector, s_lo, s_hi):
            return
        self._dispatch_chunks(s_lo, s_hi)

    def _megabatch_join(self, collector, s_lo: int,
                        s_hi: int) -> bool:
        """Park [s_lo, s_hi) as one lane of the beat's megabatch.
        The pack/pad closures run at FLUSH time with the group's pad
        rung — safe because appends to one session serialize through
        the inflight finalize, which flushes the collector before the
        segmenter can advance past this range."""
        n = s_hi - s_lo
        if n > ENG.DELTA_PADS[-1]:
            return False                # splits: solo path
        if self._rung == "kernel":
            collector.add_kernel(self, self._eng, n,
                                 lambda: self._kernel_rows(s_lo, s_hi),
                                 self._kernel_table(), s_lo)
            return True
        k_pad = self._k_bucket()

        def pad(s_pad):
            return self.seg.padded(s_lo, s_hi, s_pad, k_pad)

        collector.add_delta(self._rung, self, self._eng, n, k_pad,
                            pad, self._succ_device(), s_lo)
        return True

    def _dispatch_chunks(self, s_lo: int, s_hi: int) -> None:
        if self._rung == "kernel":
            # one launch of exactly the delta's segments (the kernel
            # reads them from device memory at any length), split
            # only above the top delta rung like the other rungs
            table = self._kernel_table()
            pos = s_lo
            while pos < s_hi:
                n = min(s_hi - pos, ENG.DELTA_PADS[-1])
                self._eng.dispatch(table, self._kernel_rows(pos, pos + n),
                                   pos)
                self.dispatches += 1
                pos += n
            return
        succ = self._succ_device()
        floor = ENG.MXU_DELTA_FLOOR if self._rung == "mxu" else 0
        k_pad = self._k_bucket()
        pos = s_lo
        while pos < s_hi:
            n = min(s_hi - pos, ENG.DELTA_PADS[-1])
            s_pad = ENG.bucket_delta(n, floor)
            n = min(n, s_pad)
            ip, it, okp, dp = self.seg.padded(pos, pos + n, s_pad,
                                              k_pad)
            self._eng.dispatch(succ, ip, it, okp, dp, pos)
            self.dispatches += 1
            pos += n

    def _finalize_range(self, s_lo: int, s_hi: int) -> None:
        st, fail_seg, n = self._eng.read()
        while st == UNKNOWN:
            if self._eng.escalate():
                # in-place capacity escalation: the pre-delta carry
                # widened, only this append's segments re-run
                self._dispatch_chunks(s_lo, s_hi)
                st, fail_seg, n = self._eng.read()
                continue
            nxt = self._next_rung()
            if nxt is None:
                self._latch(UNKNOWN, fail_seg, n)
                return
            self._reroute(note="frontier overflow", rung=nxt,
                          through=s_hi)
            st, fail_seg, n = self._eng.read()
        self.dispatched_segments = s_hi
        self._latch(st, fail_seg, n)

    def _pick(self, ns: int, nt: int, P2: int, K: int) -> str:
        """``pick_rung``, except that a rung whose frontier overflowed
        earlier in the session's life is not picked again: a replay
        starts at segment 0, so it would overflow at the same segment
        (the JAX package replays onto it and overflows again). The
        session's current rung stands in for it."""
        rung = ENG.pick_rung(ns, nt, P2, K, self.engine_policy)
        spent = {e["engine"][len("stream-"):] for e in self.engines_tried
                 if e.get("note") == "frontier overflow"}
        if rung in spent and self._rung is not None:
            return self._rung
        return rung

    def _next_rung(self) -> Optional[str]:
        ns, nt = ENG.pad_sizes(max(self.memo.n_states, 1),
                               max(self.memo.n_transitions, 1))
        if self._rung == "kernel":
            return ("mxu" if ENG.MXU.serves(ns, nt, self.P2)
                    else "xla")
        if self._rung == "xla" \
                and ENG.MXU.serves(ns, nt, self.P2):
            return "mxu"                # 2x the XLA top rung
        return None

    def _reroute(self, note: str, rung: Optional[str] = None,
                 through: Optional[int] = None) -> None:
        """The one O(history) event: rebuild the carry on a new (or
        re-shaped) rung and replay the RETAINED renamed segments.
        Amortized over the session's life; counted + attributed."""
        if self._eng is not None:
            self.engines_tried.append({
                "engine": self._eng.name, "note": note,
                "frontier_capacity": getattr(self._eng, "F", 128)})
        ns, nt = ENG.pad_sizes(max(self.memo.n_states, 1),
                               max(self.memo.n_transitions, 1))
        self._rung = rung or self._pick(ns, nt, self.P2, self.seg.k_max)
        self._succ_key = None
        self._eng = self._make_engine(self._rung, ns, nt, self.P2)
        self.replays += 1
        end = self.dispatched_segments if through is None else through
        with _obs.span("stream.replay", rung=self._rung, through=end):
            pos = 0
            while pos < end:
                n = min(end - pos, ENG.DELTA_PADS[-1])
                self._eng.begin_delta()
                self._dispatch_chunks(pos, pos + n)
                st, _, _ = self._eng.read()
                if st == UNKNOWN:
                    if self._eng.escalate():
                        continue        # same chunk, wider frontier
                    nxt = self._next_rung()
                    if nxt is None:
                        return          # caller's read sees UNKNOWN
                    return self._reroute(note="frontier overflow",
                                         rung=nxt, through=end)
                if st != VALID:
                    return              # caller's read latches it
                pos += n

    # -- verdict -------------------------------------------------------

    def _latched(self) -> bool:
        return self.valid is not True

    def _latch(self, st: int, fail_seg: int, n: int) -> None:
        self.final_count = int(n)
        if st == VALID:
            return
        self.fail_index = (int(self.seg.seg_row.a[fail_seg])
                           if 0 <= fail_seg < self.seg.n_segments
                           else -1)
        if st == INVALID:
            self.valid = False
        else:
            self.valid = "unknown"
            self.cause = (f"frontier overflow (engine="
                          f"{self._eng.name if self._eng else '?'}, "
                          f"capacity="
                          f"{getattr(self._eng, 'F', 128)})")

    def _latch_unknown(self, cause: str) -> None:
        self.valid = "unknown"
        self.cause = cause

    def _verdict_map(self) -> dict:
        out = {
            "valid": self.valid,
            "op_index": self.fail_index,
            "final_count": self.final_count,
            "op_count": len(self.ingest),
            "checked_through": self.ingest.settled,
            "segments": self.seg.n_segments,
            "engine": self._rung or "none",
            "dispatches": self.dispatches,
            "appends": self.appends,
            "replays": self.replays,
        }
        if self._eng is not None:
            out["frontier_capacity"] = getattr(self._eng, "F", 128)
        if self.cause:
            out["cause"] = self.cause
        if self.engines_tried:
            out["engines_tried"] = self.engines_tried
        return out


__all__ = ["StreamSession"]
