"""Unified linearizability analysis — the ``knossos.linear/analysis``
equivalent (``linear.clj:299-355``).

Pipeline (mirroring the reference's): ``complete`` → ``index`` → pack →
``memo`` → frontier search → decoded verdict. Small histories run on the
host engine (the analog of staying single-threaded below the reference's
128-config pmap threshold, ``linear.clj:214-216``); larger ones run the
segment-search kernel (:mod:`.seg_kernel`), whose frontier holds 128
configs: more is an overflow and the verdict is ``:unknown``, like the
reference's low-memory abort (``linear.clj:318-326``).

Not ported yet (the JAX package escalates instead): shapes the
kernel's gate rejects raise :class:`EngineNotPorted`, and a kernel
overflow is reported as UNKNOWN with no wider engine tried.
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


class EngineNotPorted(NotImplementedError):
    """The history needs an engine the port does not have yet (the
    kernel's gate rejects its shape)."""


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
             host_threshold: int = 128,
             max_states: int = 1 << 20,
             max_host_configs: int = 1 << 22,
             progress=None,
             progress_interval_s: float = 5.0,
             device=None) -> Analysis:
    """Check ``history`` against ``model`` for linearizability.

    backend: "auto" | "host" | "device".
    device: where the device search runs; ``None`` means ``cuda``, and
    raises when CUDA is absent. ``"cpu"`` runs the kernel's plain
    PyTorch version.
    progress: optional callback ``progress(done_segments,
    total_segments, frontier_count, stats)`` invoked between kernel
    launches at roughly ``progress_interval_s`` cadence — the role of
    the reference's 5-second reporter threads (``linear.clj:273-297``).
    When given, the device path runs chunked.
    """
    dev = resolve_device(device)
    t0 = _obs.monotonic()
    packed = (history if isinstance(history, PackedHistory)
              else pack_history(list(history)))
    n = len(packed)
    P = len(packed.process_table)
    if n == 0 or P == 0:
        return Analysis(valid=True, info={"backend": "trivial"})

    try:
        mm = make_memo(model, packed, max_states=max_states)
    except MemoOverflow as e:
        return Analysis(valid=UNKNOWN, info={"cause": str(e)})
    _obs.record("linear.pack", t0, _obs.monotonic(), n=n, P=P)

    if backend == "host" or (backend == "auto" and n < host_threshold):
        return _analyze_host(mm, packed, max_host_configs, t0)
    return _analyze_device(mm, packed, t0, dev, progress=progress,
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


@_obs.traced("linear.device")
def _analyze_device(mm: MemoizedModel, packed: PackedHistory, t0: float,
                    device, progress=None,
                    progress_interval_s: float = 5.0) -> Analysis:
    from . import linear_torch as LT
    from . import seg_kernel as SK

    segs = LT.make_segments(packed)
    s_real = segs.ok_proc.shape[0]
    segs = LT.make_segments(
        packed, s_pad=_next_pow2(s_real, 64),
        k_pad=_next_pow2(segs.inv_proc.shape[1], 2))
    # slot renaming: processes map to a minimal pool of reusable slots,
    # so the slot axis scales with the history's max CONCURRENT open
    # calls instead of its process count. Pure relabeling — verdicts
    # and fail segments are unchanged (see LT.remap_slots).
    segs, P_eff = LT.remap_slots(segs)
    P = max(P_eff, 1)
    info: dict = {"backend": "device", "device": str(device),
                  "n_states": mm.n_states,
                  "n_transitions": mm.n_transitions,
                  "effective_slots": P}
    P_k = kernel_slots(P)
    sizes = dict(n_states=mm.n_states, n_transitions=mm.n_transitions,
                 P=P_k, device=device)
    if progress is None:
        r = SK.check_device_seg_kernel(mm.succ, segs, **sizes)
    else:
        r = SK.check_device_seg_kernel_chunked(
            mm.succ, segs, progress=progress,
            progress_interval_s=progress_interval_s, s_real=s_real,
            **sizes)
    if r is None:
        raise EngineNotPorted(
            f"segment-search kernel does not serve this shape (P={P_k}, "
            f"K={segs.inv_proc.shape[1]}, table={mm.n_states}x"
            f"{mm.n_transitions}); the escalation engines are not "
            "ported yet")
    status, fail_seg, n_final = r
    engine = engine_name(device)
    info["engine"] = engine
    info["frontier_capacity"] = SK.F
    if status == LT.UNKNOWN:
        # no wider engine is ported: record the attempt so the
        # artifact tells an overflow apart from a verdict
        _note_tried(info, engine, SK.F)
    info["time_s"] = _obs.monotonic() - t0
    return _device_verdict(mm, packed, segs, status, fail_seg, n_final,
                           info, device)


def _note_tried(info: dict, engine: str, capacity) -> None:
    """Record an engine attempt that did NOT produce the verdict (each
    entry names the engine and the frontier capacity it gave up at)."""
    info.setdefault("engines_tried", []).append(
        {"engine": engine, "frontier_capacity": capacity})


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
    # role, linear.clj:180-212) — kernel re-scan to the failing chunk,
    # host replay of at most one chunk from the boundary frontier, then
    # concrete failed linearization orders
    op_index = fail_at
    op = packed.ops[op_index]
    cfgs: List[dict] = []
    try:
        from . import counterexample as CE

        ce = CE.reconstruct(mm, packed, device=device)
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
