"""Batched candidate verdicts — the device half of the minimizer.

The counterpart of the JAX package's ``shrink/verdicts.py``. Every
shrink round produces B candidate sub-histories; testing them is the
batched :func:`~..checker.batch.check_batch` workload, so each
candidate costs one lane of one launch:

- candidates are grouped into pow2 kept-op buckets, and each bucket
  chunk rides ONE ``check_batch`` call (on the card: one
  ``seg_search[stream]`` launch), its batch axis pow2-padded with
  copies of the first candidate, as in the JAX package;
- candidates with no ok completion are answered VALID without a launch
  (nothing ever constrains the frontier).

Unlike the JAX package, nothing is caught around the device: a kernel
that does not build or launch, or a CUDA error, propagates to the
caller instead of turning the chunk UNKNOWN (a non-survivor the
minimizer would silently keep), so a device fault never passes as a
verdict. A chunk whose shape only the per-op vmap engine could serve
raises the ``ValueError`` of the ``build_streams=False`` layout where
the JAX package answers UNKNOWN.

:func:`check_candidate` is the one-candidate-per-launch serial control,
for benchmarks and oracles; production loops batch a round through
:func:`check_candidates`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..checker import linear_torch as LT
from ..checker.batch import check_batch, pack_batch_masked
from ..models.memo import MemoizedModel
from ..obs import trace as _obs
from ..ops.op import OK
from ..ops.packed import PackedHistory
from ..utils import next_pow2

#: smallest pow2 kept-op bucket: tiny endgame candidates share one bucket
MIN_BUCKET = 16

#: candidates per launch chunk
MAX_BATCH = 64


def bucket_of(n_rows: int) -> int:
    """The pow2 kept-op bucket a candidate lands in (floor
    :data:`MIN_BUCKET`)."""
    return next_pow2(max(int(n_rows), 1), MIN_BUCKET)


def check_candidates(parent: PackedHistory, masks: Sequence[np.ndarray],
                     memo: MemoizedModel, *, F: int = 1024,
                     engine: str = "auto", mesh=None,
                     max_batch: int = MAX_BATCH,
                     counters: Optional[dict] = None,
                     device=None) -> np.ndarray:
    """Verdict-test B candidate row masks of one packed parent.

    Returns ``int32[B]`` engine statuses (``VALID`` / ``INVALID`` /
    ``UNKNOWN`` of :mod:`~..checker.linear_torch`) aligned with
    ``masks``: ONE ``check_batch`` call per pow2 bucket chunk.
    ``counters`` (optional) accumulates ``{"dispatches",
    "candidates"}``. ``device``: ``None`` means ``cuda``. Spans: each
    chunk's row slicing is ``shrink.pack``; ``check_batch`` adds its
    own (``batch.remap``, ``batch.dispatch``, ``batch.finalize``)."""
    masks = [np.asarray(m, bool) for m in masks]
    out = np.full(len(masks), LT.VALID, np.int32)
    if counters is not None:
        counters["candidates"] = counters.get("candidates", 0) \
            + len(masks)
    ok_rows = np.asarray(parent.type) == OK
    groups: Dict[int, List[int]] = {}
    for i, m in enumerate(masks):
        if not bool((m & ok_rows).any()):
            continue                    # trivially VALID, no launch
        groups.setdefault(bucket_of(int(m.sum())), []).append(i)
    for _, idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo:lo + max_batch]
            cand = [masks[i] for i in chunk]
            b = next_pow2(len(cand))
            cand = cand + [cand[0]] * (b - len(cand))
            with _obs.span("shrink.pack", candidates=len(cand)):
                batch = pack_batch_masked(parent, cand, memo)
            status, _, _ = check_batch(batch, F=F, engine=engine,
                                       mesh=mesh, device=device)
            out[chunk] = status[:len(chunk)]
            if counters is not None:
                counters["dispatches"] = counters.get("dispatches",
                                                      0) + 1
    return out


def check_candidate(parent: PackedHistory, mask: np.ndarray,
                    memo: MemoizedModel, **kw) -> int:
    """ONE candidate, one launch: the serial control the batched path
    exists to beat. Production code batches a round's candidates
    through :func:`check_candidates`."""
    return int(check_candidates(parent, [mask], memo, **kw)[0])


__all__ = ["MAX_BATCH", "MIN_BUCKET", "bucket_of", "check_candidate",
           "check_candidates"]
