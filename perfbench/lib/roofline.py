"""The segment-search kernel's least time: what the inputs need.

The operation count is a frozen copy of the comparisons formula the
port's ``checker/seg_kernel.py`` ``needed_compares`` had when this
benchmark was written, fed with the frontier sizes that the plain
reference records (:class:`perfbench.reference.linear.Verdict`), never
with anything the kernel returns. So the count depends on the inputs
alone and reads the same whatever kernel is built.
"""

from __future__ import annotations

from typing import Iterable

from .peaks import Peaks


def needed_compares(rounds: Iterable[int], slots: int) -> int:
    """The comparisons a history's closures need at the least, from the
    frontier size ``n`` at the start of each closure round, in order:
    each of the ``n * slots`` expansions is one binary search into the
    ``n`` sorted frontier keys, ``ceil(log2(n + 1))`` comparisons; the
    ``u`` keys by which a round's ``n`` exceeds the previous round's need
    ``u * ceil(log2 u)`` to sort."""
    total, prev = 0, None
    for n in rounds:
        u = n - prev if prev is not None and n > prev else 0
        total += n * slots * n.bit_length() + u * max(u - 1, 0).bit_length()
        prev = n
    return total


def history_bytes(v) -> int:
    """Each input byte read once and each output byte written once, for
    one history of :class:`Verdict` ``v``: a segment row per completion
    (the completing slot, a depth, and a slot and a call per invocation
    before it, int32 each), the successor table (int32 per state and
    call) and the verdict (status, failing segment, frontier size)."""
    row = 4 * (2 + 2 * max(v.max_invokes, 1))
    return row * v.segments + 4 * v.states * v.transitions + 12


def need(verdicts) -> tuple:
    """``(operations, bytes)`` of a list of verdicts."""
    ops = sum(needed_compares(v.rounds, v.slots) for v in verdicts)
    return ops, sum(history_bytes(v) for v in verdicts)


def least_seconds(ops: float, nbytes: float, peaks: Peaks) -> float:
    """The larger of operations over the int32 rate and bytes over the
    memory's rate."""
    return max(ops / peaks.int32_ops_per_s, nbytes / peaks.hbm_bytes_per_s)


def kernel_share(ctx, kind: str):
    """The segment search's roofline share in its launches of one kind
    (``seg_search`` or ``seg_search_stream``), in %: the least time of
    what the slice's inputs need of that kind, over the card's time in
    the kernel's runs of that kind in the profiler's trace. None where
    the trace shows no such run, or the cell's caller says nothing of
    what its inputs need."""
    t = ctx.device_seconds(lambda o: o.kind == kind)
    ops, nbytes = ctx.need.get(kind, (0, 0))
    if not t or not ops or ctx.peaks is None:
        return None
    return 100.0 * least_seconds(ops, nbytes, ctx.peaks) / t
