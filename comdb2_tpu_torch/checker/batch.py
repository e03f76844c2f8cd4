"""Batched history packing and checking — many independent histories,
one launch.

The counterpart of the JAX package's ``checker/batch.py``: the device
analog of ``jepsen.independent``'s per-key partitioning
(``independent.clj:252-300``). N short histories (e.g. one per register
key) share one interned transition table and one memoized model, and
check as ONE device computation:

- engine ``stream``: every history through the segment-search kernel in
  its RESET stream mode, G group streams, one warp each
  (:func:`~.seg_kernel.stream_dispatch`); histories that overflow the
  kernel's 128-config frontier escalate through the engines below at
  the caller's capacity F;
- engine ``keys``: the frontier as packed ``(hi, lo)`` int32 key pairs,
  one per-batch block sort per closure iteration
  (:func:`~.linear_torch.check_device_keys`, the pair-sort kernel on
  the card);
- engine ``mxu``: the MXU frontier engine's batched form, for wide P;
- engine ``flat``: all frontiers as one explicit ``(B*F, P)`` tensor
  with the batch id as the top field of a two-word sort key
  (:func:`~.linear_torch.check_device_flat`);
- engine ``vmap``: the per-op engine over the dense ``(B, n_pad)`` step
  streams, every lane's closure frozen at its own fixed point
  (:func:`~.linear_torch.check_device_batch`), the last resort that
  serves every shape.

``auto`` and escalation pick in the JAX package's order: ``mxu`` when
the batch's slot count, rounded up to a power of two, reaches
``mxu.MIN_P`` = 16 (any batch with more than 8 processes), else
``keys`` when its 62-bit key layout fits (the pair sort runs only for
batches of at most 8 slots), else ``flat`` when its key budget fits,
else ``vmap``.

The reference's shape floors (``n_pad`` of :func:`pack_batch`,
``s_pad``/``k_pad`` of :func:`segment_batch`, and those with
``n_states_pad``, ``n_transitions_pad`` and ``p_eff_pad`` of
:func:`check_batch`) are taken with the same defaults and change no
verdict. They bucket shapes so that XLA compiles one program per bucket;
eager torch and the runtime-sized kernel launch compile nothing per
shape, so they need none: ``n_pad``, ``s_pad`` and ``k_pad`` floor the
host arrays as in the reference, and the table and slot floors are
accepted and not used.

Not ported yet: the mesh routes raise
:class:`~.linear.EngineNotPorted`. ``check_batch_async`` stages nothing
ahead:
its ``finalize`` is computed when it is called, and the batch is not
sliced for host/device overlap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from ..models.memo import MemoizedModel, memoize_model, transitions_of
from ..models.model import Model
from ..obs import trace as _obs
from ..ops.op import FAIL, INVOKE, OK, Op
from ..ops.packed import PackedHistory, pack_history
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device
from . import linear_torch as LT
from . import mxu as MXU
from . import seg_kernel as SK
from .linear import EngineNotPorted, kernel_slots


@dataclass
class PackedBatch:
    """N histories compiled against one shared successor table."""

    packeds: List[PackedHistory]
    memo: MemoizedModel
    kind: np.ndarray   # int32[N, n_pad]
    proc: np.ndarray   # int32[N, n_pad]
    tr: np.ndarray     # int32[N, n_pad] — ids into the shared table
    P: int             # max process count (slot width)
    remaps: List[np.ndarray] = None  # per-history local→union trans ids

    def __len__(self) -> int:
        return len(self.packeds)


def _malformed(p: PackedHistory) -> bool:
    """True when some process invokes while an earlier invocation is
    still pending. Batch paths isolate such histories and report them
    ``unknown`` (the reference wraps per-key checker exceptions the same
    way, ``checker.clj:54-64``). Cached per PackedHistory."""
    from ..ops.columnar import _per_process_prev

    cached = getattr(p, "_malformed_cache", None)
    if cached is not None:
        return cached
    t = np.asarray(p.type)
    inv = (t == INVOKE) & ~np.asarray(p.fails)
    sel = np.flatnonzero(inv | (t == OK) | (t == FAIL))
    if not sel.size:
        out = False
    else:
        _, inv_flag, prev_inv, _ = _per_process_prev(
            np.asarray(p.process), sel, inv)
        out = bool(np.any(inv_flag & prev_inv))
    try:
        p._malformed_cache = out
    except AttributeError:
        pass
    return out


def _empty_stream():
    """A 1-segment all-padding SegmentStream (engines yield VALID)."""
    return LT.SegmentStream(
        np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.int32),
        np.full(1, -1, np.int32), np.zeros(1, np.int64),
        np.zeros(1, np.int32))


def _segments_of(p):
    """``make_segments``, or the exact stream cached on the
    PackedHistory."""
    segs = getattr(p, "_segments_exact", None)
    return LT.make_segments(p) if segs is None else segs


@_obs.traced("batch.pack")
def pack_batch(histories: Sequence[Union[Sequence[Op], PackedHistory]],
               model: Model, max_states: int = 1 << 20, n_pad: int = 0,
               build_streams: bool = True) -> PackedBatch:
    """Pack histories for :func:`check_batch`: transition ids are
    re-interned into one union table so all histories share a single
    memoized model; the BFS depth bound is the max invocation count
    over the batch.

    ``n_pad`` floors the per-op stream width (a power of two at least
    the longest history). ``build_streams=False`` skips the dense
    per-op (N, n_pad) step streams, which only the vmap engine reads:
    such a batch checks through the other engines, and a kernel
    overflow that only the vmap engine could take stays ``unknown``."""
    packeds = [h if isinstance(h, PackedHistory) else pack_history(list(h))
               for h in histories]
    union: List[tuple] = []
    ids = {}
    remaps = []
    for p in packeds:
        local = []
        for t in transitions_of(p):
            if t not in ids:
                ids[t] = len(union)
                union.append(t)
            local.append(ids[t])
        remaps.append(np.asarray(local, np.int32))
    n_inv = max((int(((p.type == INVOKE) & ~p.fails).sum())
                 for p in packeds), default=0)
    mm = memoize_model(model, union, max_states=max_states, max_depth=n_inv)

    P = max((len(p.process_table) for p in packeds), default=1)
    if not build_streams:
        empty = np.zeros((len(packeds), 0), np.int32)
        return PackedBatch(packeds=packeds, memo=mm, kind=empty,
                           proc=empty, tr=empty, P=P, remaps=remaps)
    n_pad = max(n_pad, _next_pow2(max((len(p) for p in packeds),
                                      default=1)))
    kinds, procs, trs = [], [], []
    for p, remap in zip(packeds, remaps):
        s = LT.make_stream(p, n_pad=n_pad)
        tr = s.tr.copy()
        mask = s.kind == LT.K_INVOKE
        if remap.size:
            tr[mask] = remap[tr[mask]]
        kinds.append(s.kind)
        procs.append(s.proc)
        trs.append(tr)
    return PackedBatch(packeds=packeds, memo=mm, kind=np.stack(kinds),
                       proc=np.stack(procs), tr=np.stack(trs), P=P,
                       remaps=remaps)


def pack_batch_masked(parent: PackedHistory, masks: Sequence,
                      memo: MemoizedModel) -> PackedBatch:
    """The shrink path: B sub-history candidates of ONE packed parent as
    a :class:`PackedBatch`, without re-packing or re-interning. Every
    candidate is a pair-closed row slice
    (:func:`~..ops.columnar.subset_packed`) whose id tables are the
    parent's, so the union transition table is the parent's and every
    remap is the identity: :func:`pack_batch`'s union pass over all the
    candidates' ops disappears.

    ``memo`` must be memoized over the parent's transitions with a depth
    bound at least the parent's invoke count (a candidate cannot
    linearize more ops than the parent invoked, so one memo serves every
    round). Packed with the ``build_streams=False`` layout: candidates
    check through the stream, keys, mxu and flat engines, and a kernel
    overflow that only the vmap engine could take stays ``unknown``."""
    from ..ops.columnar import subset_packed

    packeds = [subset_packed(parent, m) for m in masks]
    ident = np.arange(len(parent.transition_table), dtype=np.int32)
    empty = np.zeros((len(packeds), 0), np.int32)
    return PackedBatch(packeds=packeds, memo=memo, kind=empty,
                       proc=empty, tr=empty,
                       P=max(len(parent.process_table), 1),
                       remaps=[ident] * len(packeds))


@dataclass
class SegmentBatch:
    """Per-ok segment tensors for the batched engines: (S, B, K)."""

    inv_proc: np.ndarray   # int32[S, B, K]
    inv_tr: np.ndarray     # int32[S, B, K] — union transition ids
    ok_proc: np.ndarray    # int32[S, B]
    seg_index: np.ndarray  # int64[B, S] — segment → history index
    depth: np.ndarray      # int32[S] — max pending depth across lanes


@_obs.traced("batch.segments")
def segment_batch(batch: PackedBatch, streams: Optional[list] = None,
                  s_pad: int = 0, k_pad: int = 0) -> SegmentBatch:
    """Each history's per-ok segments (union transition ids), padded to
    a common (S, K). Malformed histories get an empty stream.
    ``streams``: per-history SegmentStreams already union-remapped (and
    possibly slot-renamed), e.g. from :func:`_stream_segments`.
    ``s_pad``/``k_pad`` floor S and K (the maxima win when larger)."""
    prebuilt = streams is not None
    segss = streams if prebuilt else [
        _empty_stream() if _malformed(p) else _segments_of(p)
        for p in batch.packeds]
    S = max(_next_pow2(max((s.ok_proc.shape[0] for s in segss),
                           default=1)), s_pad)
    K = max(_next_pow2(max((s.inv_proc.shape[1] for s in segss),
                           default=1), 2), k_pad)
    ips, its, ops, idxs, deps = [], [], [], [], []
    for remap, s in zip(batch.remaps, segss):
        ds, dk = S - s.ok_proc.shape[0], K - s.inv_proc.shape[1]
        inv_proc = np.pad(s.inv_proc, ((0, ds), (0, dk)),
                          constant_values=-1)
        tr = np.pad(s.inv_tr, ((0, ds), (0, dk)))
        mask = inv_proc >= 0
        if remap.size and not prebuilt:
            tr[mask] = remap[tr[mask]]
        ips.append(inv_proc)
        its.append(tr)
        ops.append(np.pad(s.ok_proc, (0, ds), constant_values=-1))
        idxs.append(np.pad(s.seg_index, (0, ds)))
        deps.append(np.pad(s.depth, (0, ds)))
    return SegmentBatch(
        inv_proc=np.stack(ips, axis=1),
        inv_tr=np.stack(its, axis=1),
        ok_proc=np.stack(ops, axis=1),
        seg_index=np.stack(idxs, axis=0),
        depth=np.max(np.stack(deps, axis=0), axis=0))


@_obs.traced("batch.remap")
def _build_streams(batch: PackedBatch, indices):
    """Union-remapped, slot-renamed SegmentStreams for a subset of the
    batch. Returns ``(streams, p_eff)``; slot renaming runs the batched
    :func:`~.linear_torch.remap_slots_batch`."""
    raw: list = []
    for i in indices:
        p = batch.packeds[i]
        s = _empty_stream() if _malformed(p) else _segments_of(p)
        remap = np.asarray(batch.remaps[i], np.int32)
        if remap.size:
            inv_tr = np.where(s.inv_proc >= 0, remap[s.inv_tr],
                              0).astype(np.int32)
        else:  # no successful invokes anywhere: nothing to remap
            inv_tr = np.zeros_like(s.inv_tr, np.int32)
        raw.append(LT.SegmentStream(s.inv_proc, inv_tr, s.ok_proc,
                                    s.seg_index, s.depth))
    out, pes = LT.remap_slots_batch(raw)
    return out, max([1] + pes)


def _stream_segments(batch: PackedBatch):
    """Per-history SegmentStreams with transition ids remapped into the
    union table and process ids renamed to minimal reusable slots.
    Returns ``(streams, P_eff)``, cached on the batch: escalation and
    repeat checks reuse it."""
    cached = getattr(batch, "_stream_seg_cache", None)
    if cached is None:
        cached = _build_streams(batch, range(len(batch.packeds)))
        batch._stream_seg_cache = cached
    return cached


def _slice_spec(streams, sizes):
    """Kernel spec for one dispatch, derived from the renamed streams
    themselves (every allocated slot appears in the arrays, so max slot
    id + 1 IS the effective P)."""
    pe, K = 0, 1
    for s in streams:
        K = max(K, s.inv_proc.shape[1])
        if s.inv_proc.size:
            pe = max(pe, int(s.inv_proc.max()) + 1)
        if s.ok_proc.size:
            pe = max(pe, int(s.ok_proc.max()) + 1)
    return SK.spec_for(sizes["n_states"], sizes["n_transitions"],
                       kernel_slots(pe), K + (K & 1))


def _stream_stage(batch: PackedBatch, succ, sizes, device, info=None):
    """Build the renamed streams (cached on the batch) and run the
    stream kernel over the whole batch in one launch. Returns
    ``(verdicts, segs_list)``: ``verdicts`` is the per-history
    ``(status, fail_seg_local, n)`` list, or None when the shape cannot
    run in the kernel — ``segs_list`` is complete either way, so the
    other engines reuse the streams."""
    segs_list, _ = _stream_segments(batch)
    spec = _slice_spec(segs_list, sizes)
    if spec is None:
        return None, segs_list
    with _obs.span("batch.dispatch", engine="stream", start=0,
                   end=len(batch)):
        rs = SK.stream_dispatch(succ, segs_list, spec, sizes["n_states"],
                                sizes["n_transitions"], device, info=info)
    return rs, segs_list


def pick_engine(b: int, n_states: int, n_transitions: int, P: int) -> str:
    """The engine for ``b`` histories of slot width ``P`` (a power of
    two) over an ``n_states`` x ``n_transitions`` table, in the JAX
    package's order: wide P goes to the MXU engine first; then the
    key-pair engine when its 62-bit layout fits, the flat engine when
    its budget fits, and the per-op vmap engine, which serves every
    shape."""
    if MXU.serves(n_states, n_transitions, P):
        return "mxu"
    if LT.KeyLayout(b, n_states, n_transitions, P).fits:
        return "keys"
    if LT.flat_pack_bits(b, n_states, n_transitions, P)[3]:
        return "flat"
    return "vmap"


#: the reference's table and slot floors, which ``check_batch`` and
#: ``check_batch_async`` accept as keywords (default 0) and do not use:
#: the port sizes the table and the slots from the batch
REFERENCE_PADS = ("n_states_pad", "n_transitions_pad", "p_eff_pad")


def check_batch(batch: PackedBatch, F: int = 256, mesh=None,
                engine: str = "auto", info: Optional[dict] = None,
                s_pad: int = 0, k_pad: int = 0, device=None,
                **reference_pads):
    """Run the batched device search (see :func:`check_batch_async`);
    malformed histories (double-pending process) come back ``unknown``.
    The ``*_pad`` floors are the reference's (see the module note):
    they change no verdict."""
    return check_batch_async(batch, F=F, mesh=mesh, engine=engine,
                             info=info, s_pad=s_pad, k_pad=k_pad,
                             device=device, **reference_pads)()


def check_batch_async(batch: PackedBatch, F: int = 256, mesh=None,
                      engine: str = "auto", info: Optional[dict] = None,
                      s_pad: int = 0, k_pad: int = 0, device=None,
                      **reference_pads):
    """Return a zero-argument ``finalize()`` producing ``(status[N],
    fail_at[N], n_final[N])`` NumPy arrays — fail_at in history-index
    terms.

    engine: "stream" runs every history through the segment-search
    kernel's stream mode; "keys" keeps the frontier as packed int32 key
    pairs; "mxu" is the wide-P engine; "flat" folds all frontiers into
    one explicit tensor with the batch id as the top sort field; "vmap"
    is the per-op fallback over the dense step streams; "auto" picks
    the stream kernel when its gate fits, else the first of mxu, keys,
    flat and vmap that serves the shape. ``device``: ``None`` means
    ``cuda``.

    The engines run when this is called (the batch is not sliced for
    host/device overlap yet): ``finalize`` only decodes and escalates.
    ``info`` receives ``{"engine": name}`` for the path executed; the
    flat and vmap engines add ``engine_stats`` (closure iterations,
    frontier rows expanded, host syncs), and an escalation
    ``{"escalated": {"engine", "count", "engine_stats"}}``, its wall
    time ``escalation_s`` and the escalated lanes
    ``escalation_lanes``.
    ``s_pad``/``k_pad`` floor the keys and MXU engines' segment axes;
    the other keywords the reference takes (:data:`REFERENCE_PADS`) are
    accepted and not used, and any other keyword raises ``TypeError``."""
    unknown = sorted(set(reference_pads) - set(REFERENCE_PADS))
    if unknown:
        raise TypeError(f"check_batch got unexpected keyword arguments "
                        f"{unknown}")
    fin = _check_batch_begin(batch, F=F, mesh=mesh, engine=engine,
                             info=info, device=device, s_pad=s_pad,
                             k_pad=k_pad)

    def finalize():
        status, fail_at, n_final = fin()
        bad = [i for i, p in enumerate(batch.packeds) if _malformed(p)]
        if bad:
            status = np.array(status, np.int32)
            fail_at = np.array(fail_at, np.int64)
            n_final = np.array(n_final, np.int32)
            status[bad] = LT.UNKNOWN
            fail_at[bad] = -1
            n_final[bad] = 0
        return status, fail_at, n_final

    return finalize


def _check_batch_begin(batch: PackedBatch, F: int, mesh, engine: str,
                       info: Optional[dict], device, s_pad: int = 0,
                       k_pad: int = 0):
    """Engine selection, host packing and the device run; returns the
    finalize closure (fail-index decode, kernel overflow escalation)."""
    if mesh is not None:
        raise EngineNotPorted("check_batch: the mesh routes are not "
                              "ported yet")
    dev = resolve_device(device)
    n_states = batch.memo.n_states
    n_transitions = batch.memo.n_transitions
    succ = LT.pad_succ(batch.memo.succ, _next_pow2(n_states),
                       _next_pow2(n_transitions))
    P = _next_pow2(batch.P, 2)
    B = len(batch)
    sizes = {"n_states": n_states, "n_transitions": n_transitions}

    def note(name: str) -> None:
        if info is not None:
            info["engine"] = name

    def stream_fits():
        # gate BEFORE the O(total-ops) segment pass; P is not final
        # here (slot renaming can shrink it), so check at P=1
        return SK.spec_for(n_states, n_transitions, 1, 8) is not None

    if engine == "auto":
        engine = ("stream" if stream_fits()
                  else pick_engine(B, n_states, n_transitions, P))
    prebuilt_streams = None
    if engine == "stream":
        rs = None
        if stream_fits():
            rs, segs_list = _stream_stage(
                batch, succ, sizes, dev, info=None if info is None else info.setdefault(
                    "stream", {}))
            prebuilt_streams = segs_list
        if rs is not None:
            note("stream")

            @_obs.traced("batch.finalize")
            def finalize_stream():
                status = np.array([r[0] for r in rs], np.int32)
                fail_at = np.array([
                    segs_list[b].seg_index[rs[b][1]] if rs[b][1] >= 0
                    else -1 for b in range(B)], np.int64)
                n_final = np.array([r[2] for r in rs], np.int32)
                # the kernel's frontier is fixed at 128: histories that
                # overflowed it get the requested budget F through the
                # other engines instead of a spurious UNKNOWN
                unk = escalation_indices(status, F, SK.F)
                # the sub-batch's own size: its budgets fit where the
                # whole batch's may not
                esc_engine = pick_engine(max(int(unk.size), 1), n_states,
                                         n_transitions, P)
                if unk.size and batch.kind.shape[1] == 0 \
                        and esc_engine == "vmap":
                    # packed with build_streams=False and only the vmap
                    # engine could take the overflow: those histories
                    # stay unknown, and info says escalation was asked
                    # for and impossible
                    if info is not None:
                        info["escalated"] = {"engine": None,
                                             "count": int(unk.size)}
                    unk = np.empty(0, np.int64)
                if unk.size:
                    sub = PackedBatch(
                        packeds=[batch.packeds[i] for i in unk],
                        memo=batch.memo, kind=batch.kind[unk],
                        proc=batch.proc[unk], tr=batch.tr[unk],
                        P=batch.P, remaps=[batch.remaps[i] for i in unk])
                    sub_info: dict = {}
                    t_esc = _obs.monotonic()
                    st2, fa2, n2 = check_batch(
                        sub, F=F, engine=esc_engine, info=sub_info,
                        s_pad=s_pad, k_pad=k_pad, device=dev)
                    status, fail_at, n_final = merge_escalation(
                        status, fail_at, n_final, unk, st2, fa2, n2)
                    if info is not None:
                        info["escalated"] = {
                            "engine": sub_info.get("engine"),
                            "count": int(unk.size)}
                        info["escalation_s"] = _obs.monotonic() - t_esc
                        info["escalation_lanes"] = unk.tolist()
                        if "engine_stats" in sub_info:
                            info["escalated"]["engine_stats"] = \
                                sub_info["engine_stats"]
                return status, fail_at, n_final

            return finalize_stream
        engine = pick_engine(B, n_states, n_transitions, P)
    if engine not in ("mxu", "keys", "flat", "vmap"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "mxu" and not MXU.fits(n_states, n_transitions, P):
        raise ValueError("mxu engine requires the table caps and a "
                         "lossless PackPlan (see mxu.fits)")
    if engine == "vmap":
        if batch.kind.shape[1] == 0:
            raise ValueError(
                "batch was packed with build_streams=False; the vmap path "
                "needs the dense step streams")
        note(engine)
        stats: dict = {}
        out = LT.check_device_batch(succ, batch.kind, batch.proc, batch.tr,
                                    F=F, P=P, device=dev, stats=stats,
                                    **sizes)
        if info is not None:
            info["engine_stats"] = stats
        res = tuple(x.cpu().numpy() for x in out)
        return _obs.traced("batch.finalize")(
            lambda: (res[0], res[1].astype(np.int64), res[2]))
    note(engine)
    if engine == "mxu":
        # bucket the caller's F to the engine's capacity ladder
        F = MXU.bucket_F(F)
        if info is not None:
            info["frontier_capacity"] = F
    sb = segment_batch(batch, streams=prebuilt_streams, s_pad=s_pad,
                       k_pad=k_pad)
    kw = {}
    if engine == "flat":
        kw["stats"] = stats = {}
        if info is not None:
            info["engine_stats"] = stats
    fn = {"mxu": MXU.check_device_mxu_batch, "keys": LT.check_device_keys,
          "flat": LT.check_device_flat}[engine]
    status_d, fail_seg_d, n_final_d = fn(
        succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth, B=B, F=F, P=P,
        device=dev, **sizes, **kw)
    status = status_d.cpu().numpy()[:B]
    fail_seg = fail_seg_d.cpu().numpy()[:B]
    n_final = n_final_d.cpu().numpy()[:B]

    @_obs.traced("batch.finalize")
    def finalize_engine():
        fail_at = np.array([
            sb.seg_index[b, fail_seg[b]] if fail_seg[b] >= 0 else -1
            for b in range(B)], np.int64)
        return status, fail_at, n_final

    return finalize_engine


def escalation_indices(status: np.ndarray, F: int,
                       kernel_f: int) -> np.ndarray:
    """Pure: which batch indices must re-run through the other engines.
    Only UNKNOWN verdicts escalate, and only when the caller's frontier
    budget EXCEEDS the kernel's fixed one."""
    if F <= kernel_f:
        return np.empty(0, np.int64)
    return np.flatnonzero(np.asarray(status) == LT.UNKNOWN)


def merge_escalation(status, fail_at, n_final, idx, st2, fa2, n2):
    """Pure: fold the escalated sub-batch's verdicts back into the
    full-batch arrays at ``idx``."""
    status = np.array(status, np.int32)
    fail_at = np.array(fail_at, np.int64)
    n_final = np.array(n_final, np.int32)
    status[idx] = st2
    fail_at[idx] = fa2
    n_final[idx] = n2
    return status, fail_at, n_final


__all__ = ["PackedBatch", "SegmentBatch", "check_batch",
           "check_batch_async", "escalation_indices", "merge_escalation",
           "pack_batch", "pack_batch_masked", "pick_engine",
           "segment_batch"]
