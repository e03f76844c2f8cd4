"""Shape bucketing for the verifier service.

The counterpart of the JAX package's ``service/bucketing.py``, with the
same buckets, so both daemons slot and name requests alike. In the JAX
package a bucket is one compiled program; in the port the kernels take
their shapes at run time, and a bucket is the unit that requests
coalesce under (one launch per bucket chunk) and that the metrics
report. Every admitted history is quantized onto a bucket whose axes
are the shapes :func:`comdb2_tpu_torch.checker.batch.check_batch`
floors:

- ``n_pad``  — the op-stream pad (pow2, floor 16): the vmap engine's
  scan length.
- ``S``      — padded segment count (pow2, floor 8): the keys/flat
  engines' scan length and the streamed kernel's chunk budget.
- ``K``      — padded invokes-per-segment (pow2, floor 2).
- ``P``      — the slot-tensor width the engines compile for. This is
  the pow2 of the PROCESS-table size (what ``check_batch`` derives
  its ``P`` from), not the renamed-slot count — two histories with
  equal concurrency but different process counts would otherwise
  compile two programs.

The dispatcher additionally floors the memoized table sizes
(``n_states``/``n_transitions``) to pow2 per batch and passes them on,
as the JAX package's does (the port's engines accept them and size
their keys from the batch).

Histories the bucket table can't serve cheaply (too long, too many
segments, invoke bursts past the kernel's K cap, concurrency past the
slot budget) are routed to the HOST engine instead of poisoning a
batch: one slow request degrades alone, exactly like the reference
wrapping per-key checker blowups in ``check-safe``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from ..ops.packed import PackedHistory
from ..utils import next_pow2 as _next_pow2


@dataclass(frozen=True)
class ServiceLimits:
    """Admission limits — anything beyond them degrades to the host
    engine (bounded there by ``max_host_configs``, so a pathological
    history answers ``unknown`` rather than wedging the tick loop)."""

    max_ops: int = 8192          # raw history rows
    max_segments: int = 4096     # ok-op segments (chunked-engine line)
    max_invokes_per_seg: int = 8  # the fused kernel's K cap
    max_slots: int = 16          # effective concurrency (P_eff)
    max_processes: int = 32      # raw process-table width
    max_txns: int = 4096         # txn-kind graph nodes (closure N)


class Bucket(NamedTuple):
    """One shape class; ``key`` names it in metrics/replies. ``P`` is
    the batch engines' slot width (process-table pow2); ``P_eff`` the
    stream kernel's renamed-slot count (the JAX package compiles one
    program per pair; the port's kernels take both at run time)."""

    n_pad: int
    S: int
    K: int
    P: int
    P_eff: int

    @property
    def key(self) -> str:
        return (f"n{self.n_pad}-s{self.S}-k{self.K}-p{self.P}"
                f"-e{self.P_eff}")


def bucket_for(packed: PackedHistory,
               limits: ServiceLimits) -> Optional[Bucket]:
    """The bucket a packed history lands in, or None when it exceeds
    the limits (host-engine route). Raises ``ValueError`` on malformed
    histories (double-pending process — ``make_segments``' contract);
    the admission path answers those ``unknown``.

    The exact segment stream computed here is cached on ``packed``
    (``_segments_exact``) — the dispatch path's segment builders pad
    it to the bucket floors instead of re-running the O(total-ops)
    host pass (this container has ONE CPU; the pass would otherwise
    run twice per request)."""
    from ..checker import linear_torch as LT

    segs = LT.make_segments(packed)
    renamed, p_eff = LT.remap_slots(segs)
    try:
        packed._segments_exact = segs
        # the slot renaming is determined by (inv_proc, ok_proc) alone
        # — identical whether it runs before or after transition-id
        # union remapping — so the dispatch path reuses these proc
        # arrays instead of re-running the O(ops) pass per request
        packed._remap_cache = (renamed.inv_proc, renamed.ok_proc,
                               p_eff)
    except AttributeError:
        pass                     # slotted/frozen variants: recompute
    S = segs.ok_proc.shape[0]
    K = segs.inv_proc.shape[1]
    n_procs = len(packed.process_table)
    if (len(packed) > limits.max_ops or S > limits.max_segments
            or K > limits.max_invokes_per_seg
            or p_eff > limits.max_slots
            or n_procs > limits.max_processes):
        return None
    # effective slots: even-bucket while that stays in the kernel's
    # (8,128) tier; past it use the exact count — a pad slot there can
    # cost a whole extra key word (same rule as the engine ladder's P_k in
    # checker/linear.py)
    pe = max(p_eff + (p_eff & 1), 2)
    if pe > 7:
        pe = max(p_eff, 2)
    return Bucket(n_pad=_next_pow2(len(packed), 16),
                  S=_next_pow2(S, 8),
                  K=_next_pow2(K, 2),
                  P=_next_pow2(max(n_procs, 2), 2),
                  P_eff=pe)


class StreamBucket(NamedTuple):
    """One stream-session compiled-shape class: the slot key
    ``kind:"stream"`` appends coalesce under. ``cls`` is the
    session's :attr:`~comdb2_tpu_torch.stream.session.StreamSession.
    shape_class` — rung, slot width, K bucket, table buckets — so
    same-shape sessions form batches together and share one megabatch
    beat."""

    cls: str

    @property
    def key(self) -> str:
        return self.cls


class WlBucket(NamedTuple):
    """One workload-family compiled-shape class (``kind:"wl"``,
    docs/workloads.md). ``sig`` holds the padded per-history axes as
    ``(letter, rung)`` pairs — the padded axes the family program
    takes —
    and names the bucket in metrics. ``model_key`` pins the bank
    model CONTENT (frozen ``{"n","total","init"}``): one dispatch
    encodes the whole chunk against ONE model, so different-model
    requests must land in different slots — but the model is data,
    not shape, so it stays out of ``key`` (same program, same
    metrics row)."""

    family: str
    sig: tuple = ()
    model_key: tuple = ()

    @property
    def key(self) -> str:
        return "wl-" + self.family + "".join(
            f"-{a}{v}" for a, v in self.sig)


#: sig-letter -> the encode kwarg it pins (per family; letters are
#: unique within each family's dim set)
_WL_DIM_KEYS = {"r": "r_pad", "a": "a_pad", "t": "t_pad",
                "e": "e_pad", "n": "n_pad", "v": "v_pad"}


def wl_dims_of(bucket: "WlBucket") -> dict:
    """The encode kwargs a WlBucket pins (inverse of the sig)."""
    return {_WL_DIM_KEYS[a]: v for a, v in bucket.sig}


def wl_bucket_for(family: str, ops,
                  model: Optional[dict] = None) -> Optional["WlBucket"]:
    """The wl bucket one history lands in, or None when an axis
    exceeds its family's top rung (host-oracle route — one big
    history degrades alone, it never poisons a batch)."""
    from ..checker.wl.batch import wl_dims

    dims = wl_dims([ops], family, model)
    if dims is None:
        return None
    sig = tuple((k[0], v) for k, v in dims.items())
    mk = ()
    if family == "bank":
        from ..checker.workloads import freeze_value

        mk = freeze_value({k: model[k] for k in
                           ("n", "total", "init") if k in model})
    return WlBucket(family=family, sig=sig, model_key=mk)


class TxnBucket(NamedTuple):
    """One shape class of the txn closure engine: the only
    shape axis is the padded txn count N (pow2, floor
    ``txn.edges.TXN_N_FLOOR``); the batch axis is pow2-padded at
    dispatch like the check kind's."""

    N: int

    @property
    def key(self) -> str:
        return f"txn-n{self.N}"


def txn_bucket_for(n_txns: int,
                   limits: ServiceLimits) -> Optional[TxnBucket]:
    """The closure bucket for an ``n_txns``-node dependency graph, or
    None past the limit (host-SCC route — one slow request degrades
    alone)."""
    from ..txn.edges import TXN_N_FLOOR

    if n_txns > limits.max_txns:
        return None
    return TxnBucket(N=_next_pow2(max(n_txns, 1), TXN_N_FLOOR))


__all__ = ["Bucket", "ServiceLimits", "StreamBucket", "TxnBucket",
           "WlBucket", "bucket_for", "txn_bucket_for",
           "wl_bucket_for", "wl_dims_of"]
