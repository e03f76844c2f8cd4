"""Unified linearizability analysis — the ``knossos.linear/analysis``
equivalent (``linear.clj:299-355``).

Pipeline (mirroring the reference's): ``complete`` → ``index`` → pack →
``memo`` → frontier search → decoded verdict. Small histories run on the
host engine (the analog of staying single-threaded below the reference's
128-config pmap threshold, ``linear.clj:214-216``); larger ones run the
device engine ladder:

1. the segment-search kernel (:mod:`.seg_kernel`, frontier 128);
2. on its overflow, or when its gate rejects the shape: the MXU
   frontier engine (:mod:`.mxu`) for wide P, else the seg2 capacity
   ladder (:func:`.linear_torch.check_device_seg2`) over
   ``capacities``.

Overflow at the last capacity yields ``:unknown``, like the
reference's low-memory abort (``linear.clj:318-326``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

from ..models.memo import MemoOverflow, MemoizedModel, memo as make_memo
from ..models.model import Model
from ..obs import trace as _obs
from ..ops.op import Op
from ..ops.packed import PackedHistory, pack_history
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device
from . import linear_host

UNKNOWN = "unknown"


@dataclass
class Analysis:
    """Checker verdict. ``valid`` is ``True``, ``False``, or
    ``"unknown"`` (search gave up — same tri-state as the reference's
    ``:valid?``)."""

    valid: Union[bool, str]
    op: Optional[Op] = None            # op at which the search died
    op_index: Optional[int] = None
    configs: List[dict] = field(default_factory=list)  # frontier sample
    final_count: int = 0
    info: dict = field(default_factory=dict)

    def to_map(self) -> dict:
        m = {"valid?": self.valid}
        if self.op is not None:
            m["op"] = self.op
            m["op-index"] = self.op_index
            m["configs"] = self.configs
        m.update(self.info)
        return m


@_obs.traced("linear.analysis")
def analysis(model: Model,
             history: Union[Sequence[Op], PackedHistory],
             backend: str = "auto",
             capacities: Sequence[int] = (256, 1024, 8192, 65536),
             host_threshold: int = 128,
             max_states: int = 1 << 20,
             max_host_configs: int = 1 << 22,
             progress=None,
             progress_interval_s: float = 5.0,
             device=None) -> Analysis:
    """Check ``history`` against ``model`` for linearizability.

    backend: "auto" | "host" | "device".
    capacities: frontier sizes the seg2 ladder tries in order after the
    kernel; overflow escalates, overflow at the last yields :unknown.
    The MXU arm (wide P) buckets each entry up to its own rung set
    (``mxu.CAPACITIES``).
    device: where the device search runs; ``None`` means ``cuda``, and
    raises when CUDA is absent. ``"cpu"`` runs every engine on CPU
    tensors, the kernel as its plain PyTorch version.
    progress: optional callback ``progress(done_segments,
    total_segments, frontier_count, stats)`` invoked between device
    chunks at roughly ``progress_interval_s`` cadence — the role of the
    reference's 5-second reporter threads (``linear.clj:273-297``).
    ``stats`` holds ``visited_per_s``, ``segs_per_s`` and ``est_cost``.
    When given, the device path runs chunked.
    """
    dev = resolve_device(device)
    t0 = _obs.monotonic()
    with _obs.span("linear.pack") as sp:
        packed = (history if isinstance(history, PackedHistory)
                  else pack_history(list(history)))
        n = len(packed)
        P = len(packed.process_table)
        sp.set(n=n, P=P)
        if n == 0 or P == 0:
            return Analysis(valid=True, info={"backend": "trivial"})

        try:
            mm = make_memo(model, packed, max_states=max_states)
        except MemoOverflow as e:
            return Analysis(valid=UNKNOWN, info={"cause": str(e)})

    if backend == "host" or (backend == "auto" and n < host_threshold):
        return _analyze_host(mm, packed, max_host_configs, t0)
    return _analyze_device(mm, packed, capacities, t0, dev,
                           progress=progress,
                           progress_interval_s=progress_interval_s)


@_obs.traced("linear.host")
def _analyze_host(mm: MemoizedModel, packed: PackedHistory,
                  max_configs: int, t0: float) -> Analysis:
    try:
        r = linear_host.check(mm, packed, max_configs=max_configs)
    except linear_host.FrontierOverflow as e:
        return Analysis(valid=UNKNOWN, info={"cause": str(e),
                                             "backend": "host"})
    info = {"backend": "host", "max_frontier": r.max_frontier,
            "time_s": _obs.monotonic() - t0}
    if r.valid:
        return Analysis(valid=True, final_count=r.final_count, info=info)
    op = packed.ops[r.op_index]
    cfgs = [linear_host.describe_config(mm, packed, c)
            for c in r.configs[:10]]
    try:
        from .counterexample import final_paths
        info["paths"] = final_paths(mm, packed, r.pre_configs,
                                    r.op_index)
    except Exception as e:
        # decoration never destroys the verdict; leave a diagnosable
        # trace in the report instead of dropping it silently
        info["paths_error"] = repr(e)
    return Analysis(valid=False, op=op, op_index=r.op_index,
                    configs=cfgs, info=info)


# histories with more padded segments than this run the chunked seg2
# engine (one host round trip per chunk, and in-place escalation)
CHUNKED_S_THRESHOLD = 4096

#: the JAX package's engine names -> the port's (the kernel runs as its
#: plain version, ``seg-reference``, on CPU tensors: see engine_name)
REFERENCE_ENGINES = {"pallas-fused": "cuda-seg", "xla-seg2": "torch-seg2",
                     "mxu-frontier": "mxu-frontier"}


def engine_name(device) -> str:
    """``cuda-seg`` for the CUDA kernel; ``seg-reference`` for its
    plain PyTorch version (CPU tensors)."""
    return "cuda-seg" if device.type == "cuda" else "seg-reference"


def kernel_slots(P_eff: int) -> int:
    """The kernel's slot count for ``P_eff`` effective slots: bucketed
    to the next even value while it stays in the 8-row tier (P <= 7);
    the 16-row tier's keys are wide enough that a pad slot can cost a
    whole extra key word, so there it is exact."""
    P = max(P_eff, 1)
    P2 = max(P + (P & 1), 2)
    return P2 if P2 <= 7 else P


def _pad_chunk(segs, done: int, end: int, chunk: int):
    """Segments ``[done, end)`` padded with dead segments to ``chunk``."""
    import numpy as np

    pad = chunk - (end - done)
    return (np.pad(segs.inv_proc[done:end], ((0, pad), (0, 0)),
                   constant_values=-1),
            np.pad(segs.inv_tr[done:end], ((0, pad), (0, 0))),
            np.pad(segs.ok_proc[done:end], (0, pad), constant_values=-1),
            np.pad(segs.depth[done:end], (0, pad)))


@_obs.traced("linear.device")
def _analyze_device(mm: MemoizedModel, packed: PackedHistory,
                    capacities: Sequence[int], t0: float, device,
                    progress=None,
                    progress_interval_s: float = 5.0) -> Analysis:
    from . import linear_torch as LT
    from . import mxu as MXU
    from . import seg_kernel as SK

    # the padded successor table goes to the device once — chunked runs
    # and capacity escalation reuse it
    succ = LT.as_tensor(LT.pad_succ(mm.succ, _next_pow2(mm.succ.shape[0]),
                                    _next_pow2(mm.succ.shape[1])), device)
    with _obs.span("linear.segments"):
        segs = LT.make_segments(packed)
        s_real = segs.ok_proc.shape[0]
        segs = LT.make_segments(
            packed, s_pad=_next_pow2(s_real, 64),
            k_pad=_next_pow2(segs.inv_proc.shape[1], 2))
        # slot renaming: processes map to a minimal pool of reusable
        # slots, so the slot axis scales with the history's max
        # CONCURRENT open calls instead of its process count. Pure
        # relabeling — verdicts and fail segments are unchanged (see
        # LT.remap_slots).
        segs, P_eff = LT.remap_slots(segs)
    P = max(P_eff, 1)
    info: dict = {"backend": "device", "device": str(device),
                  "n_states": mm.n_states,
                  "n_transitions": mm.n_transitions,
                  "effective_slots": P}
    sizes = {"n_states": mm.n_states, "n_transitions": mm.n_transitions}
    # the engines' slot axis: the next even value (candidate rows scale
    # with P, so pow2 padding would cost up to ~25% extra work)
    P2 = max(P + (P & 1), 2)
    # the kernel first: the whole segment loop in one launch, frontier
    # fixed at 128. None = its gate rejects the shape (P > 15, K > 8,
    # table over 8192 entries, keys wider than 3 words)
    P_k = kernel_slots(P)
    ksizes = dict(sizes, P=P_k, device=device)
    with _obs.span("linear.kernel", P=P_k):
        if progress is None:
            r = SK.check_device_seg_kernel(mm.succ, segs, **ksizes)
        else:
            r = SK.check_device_seg_kernel_chunked(
                mm.succ, segs, progress=progress,
                progress_interval_s=progress_interval_s, s_real=s_real,
                **ksizes)
    if r is not None:
        status, fail_seg, n_final = r
        info["engine"] = engine_name(device)
        info["frontier_capacity"] = SK.F
        if status != LT.UNKNOWN:
            info["time_s"] = _obs.monotonic() - t0
            return _device_verdict(mm, packed, segs, status, fail_seg,
                                   n_final, info, device)
        # kernel overflow: record the attempt, then escalate — the
        # artifact says which engine produced the verdict and what was
        # tried on the way
        _note_tried(info, engine_name(device), SK.F)

    # wide P with bounded in-flight rides the MXU frontier engine, whose
    # ladder tops out at 2x the seg2 ladder's
    if MXU.serves(mm.n_states, mm.n_transitions, P2):
        return _analyze_mxu(mm, packed, segs, succ, P2, t0, info, device,
                            capacities=capacities, progress=progress,
                            progress_interval_s=progress_interval_s,
                            s_real=s_real)

    # the seg2 ladder; each segment first runs at the small tier Fs and
    # escalates to F on overflow
    info["engine"] = "torch-seg2"
    Fs = 32
    chunked = (progress is not None
               or segs.ok_proc.shape[0] > CHUNKED_S_THRESHOLD)
    if not chunked:
        for F in capacities:
            status, fail_seg, n_final = LT.check_device_seg2(
                succ, segs.inv_proc, segs.inv_tr, segs.ok_proc,
                segs.depth, F=F, Fs=Fs, P=P2, **sizes)
            info["frontier_capacity"] = F
            if status != LT.UNKNOWN:
                break
    else:
        # chunked, with IN-PLACE capacity escalation: an overflow
        # re-runs only the overflowing chunk from the boundary carry
        # widened to the next capacity
        S = segs.ok_proc.shape[0]
        chunk = max(_next_pow2(min(S, 2048)), 64)
        cap_ix = 0
        F = capacities[cap_ix]
        carry = LT.init_seg_carry(F, P2, device)
        t_run = _obs.monotonic()
        last = t_run
        done = 0
        visited = 0
        while done < S:
            end = min(done + chunk, S)
            new_carry = LT.check_device_seg2_chunk(
                succ, *_pad_chunk(segs, done, end, chunk), done, carry,
                F=F, Fs=Fs, P=P2, **sizes)
            st = new_carry[4]
            if st == LT.UNKNOWN and cap_ix + 1 < len(capacities):
                cap_ix += 1
                F = capacities[cap_ix]
                carry = LT.expand_seg_carry(carry, F)
                continue            # same chunk, wider frontier
            carry = new_carry
            visited += carry[3] * (end - done)
            done = end
            if st != LT.VALID:
                break
            now = _obs.monotonic()
            if progress is not None and now - last >= progress_interval_s:
                hist = LT.pending_histogram(carry[1], carry[2], P=P2)
                el = max(now - t_run, 1e-9)
                progress(min(done, s_real), s_real, carry[3],
                         {"visited_per_s": visited / el,
                          "segs_per_s": done / el,
                          "est_cost": LT.estimated_cost_hist(
                              hist.tolist())})
                last = now
        status, fail_seg, n_final = carry[4], carry[5], carry[3]
        info["frontier_capacity"] = F
    info["time_s"] = _obs.monotonic() - t0
    return _device_verdict(mm, packed, segs, status, fail_seg, n_final,
                           info, device)


def _note_tried(info: dict, engine: str, capacity) -> None:
    """Record an engine attempt that did NOT produce the verdict (each
    entry names the engine and the frontier capacity it gave up at)."""
    info.setdefault("engines_tried", []).append(
        {"engine": engine, "frontier_capacity": capacity})


@_obs.traced("linear.mxu")
def _analyze_mxu(mm: MemoizedModel, packed: PackedHistory, segs, succ,
                 P: int, t0: float, info: dict, device,
                 capacities: Optional[Sequence[int]] = None,
                 progress=None, progress_interval_s: float = 5.0,
                 s_real: Optional[int] = None) -> Analysis:
    """The MXU frontier engine's arm: capacity ladder over
    ``mxu.CAPACITIES`` with the seg2 arm's chunked / in-place-escalation
    discipline. Terminal for the shapes it serves: overflow past its top
    rung is the UNKNOWN, attributed to this engine.

    ``capacities`` (the caller's bound) buckets each entry UP to the
    smallest rung that holds it, and the ladder runs only those rungs."""
    from . import linear_torch as LT
    from . import mxu as MXU

    if capacities is None:
        ladder = tuple(MXU.CAPACITIES)
    else:
        ladder = tuple(sorted({MXU.bucket_F(f) for f in capacities}))
    info["engine"] = "mxu-frontier"
    sizes = {"n_states": mm.n_states, "n_transitions": mm.n_transitions}
    S = segs.ok_proc.shape[0]
    if s_real is None:
        s_real = S
    chunked = (progress is not None or S > CHUNKED_S_THRESHOLD)
    if not chunked:
        for F in ladder:
            status, fail_seg, n_final = MXU.check_device_mxu(
                succ, segs.inv_proc, segs.inv_tr, segs.ok_proc,
                segs.depth, F=F, P=P, **sizes)
            info["frontier_capacity"] = F
            if status != LT.UNKNOWN:
                break
    else:
        chunk = max(_next_pow2(min(S, MXU.CHUNK)), 64)
        cap_ix = 0
        F = ladder[cap_ix]
        carry = MXU.init_carry(1, F, P, device=device, **sizes)
        t_run = _obs.monotonic()
        last = t_run
        done = 0
        visited = 0
        while done < S:
            end = min(done + chunk, S)
            new_carry = MXU.check_device_mxu_chunk(
                succ, *_pad_chunk(segs, done, end, chunk), done, carry,
                F=F, P=P, **sizes)
            st = int(new_carry[3][0])
            if st == LT.UNKNOWN and cap_ix + 1 < len(ladder):
                cap_ix += 1
                F = ladder[cap_ix]
                carry = MXU.expand_carry(carry, F)
                continue            # same chunk, wider frontier
            carry = new_carry
            visited += int(carry[2][0]) * (end - done)
            done = end
            if st != LT.VALID:
                break
            now = _obs.monotonic()
            if progress is not None and now - last >= progress_interval_s:
                hist = MXU.pending_histogram(carry[0], carry[1], P=P,
                                             **sizes)
                el = max(now - t_run, 1e-9)
                progress(min(done, s_real), s_real, int(carry[2][0]),
                         {"visited_per_s": visited / el,
                          "segs_per_s": done / el,
                          "est_cost": LT.estimated_cost_hist(
                              hist.tolist())})
                last = now
        status, fail_seg, n_final = (int(carry[3][0]), int(carry[4][0]),
                                     int(carry[2][0]))
        info["frontier_capacity"] = F
    info["time_s"] = _obs.monotonic() - t0
    return _device_verdict(mm, packed, segs, status, fail_seg, n_final,
                           info, device)


@_obs.traced("linear.decode")
def _device_verdict(mm, packed, segs, status, fail_seg, n_final,
                    info, device) -> Analysis:
    """Decode an engine's (status, fail_segment, n) into an Analysis."""
    from . import linear_torch as LT

    fail_at = (int(segs.seg_index[int(fail_seg)])
               if int(fail_seg) >= 0 else -1)
    if status == LT.VALID:
        return Analysis(valid=True, final_count=int(n_final), info=info)
    if status == LT.UNKNOWN:
        cause = (f"frontier overflow (engine="
                 f"{info.get('engine', '?')}, capacity="
                 f"{info.get('frontier_capacity', '?')})")
        return Analysis(valid=UNKNOWN, op_index=fail_at,
                        info={**info, "cause": cause})
    # invalid: bounded counterexample reconstruction (the final-paths
    # role, linear.clj:180-212) — device re-scan to the failing chunk,
    # host replay of at most one chunk from the boundary frontier, then
    # concrete failed linearization orders
    op_index = fail_at
    with _obs.span("linear.decode.ops"):
        op = packed.ops[op_index]
    cfgs: List[dict] = []
    try:
        from . import counterexample as CE

        # F >= the verdict's capacity: a larger frontier cannot change
        # an INVALID verdict (overflow would have been UNKNOWN); the
        # seg2 re-scan tops out at 65536
        ce = CE.reconstruct(mm, packed, device=device,
                            F=max(256, min(info.get(
                                "frontier_capacity", 256), 65536)))
        if ce is not None:
            cfgs = ce.configs
            op_index = ce.op_index
            op = packed.ops[op_index]
            info = {**info, "paths": ce.paths}
    except (linear_host.FrontierOverflow, ValueError) as e:
        # decoration must never destroy an already-decided verdict (a
        # host-replay overflow or an owner-map mismatch degrades to an
        # undecorated INVALID); a kernel build or launch error is not
        # decoration and propagates
        import logging

        logging.getLogger(__name__).warning(
            "counterexample reconstruction failed (%s: %s) — "
            "returning undecorated INVALID", type(e).__name__, e)
    return Analysis(valid=False, op=op, op_index=op_index, configs=cfgs,
                    info=info)
