"""The traced run's device trace: ``torch.profiler`` over the slice of
the run that the harness profiles.

The profiler records the card's kernels, copies and sets. The program's
kernels launch through wrappers that name each launch's kind (the
segment search's ``seg_search`` for a single history or a carry,
``seg_search_stream`` for a stream launch); the harness records the
kinds in launch order, and :meth:`Trace.name_launches` gives each run of
the kernel its kind. The trace's clock is tied to ``time.monotonic``,
the clock of the program's spans and of the harness's calls, so an idle
stretch of the card can be put down to what the host was doing then.
Nothing is written to disk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

#: the segment-search kernel, and its launch kinds
SEG_KERNEL = "seg_search_kernel"
SEG_KINDS = ("seg_search", "seg_search_stream")


@dataclass
class DeviceOp:
    name: str
    t0: float          # seconds on the monotonic clock
    t1: float
    kind: Optional[str] = None     # the launch kind, for the program's own


@dataclass
class Trace:
    ops: List[DeviceOp] = field(default_factory=list)

    def name_launches(self, kinds: List[str]) -> None:
        """Give each run of the segment-search kernel its launch kind:
        the wrappers' launches of it in order, against its runs in the
        trace in the order they started. Where the counts differ (a
        launch the trace lost), no run gets a kind."""
        mine = [k for k in kinds if k in SEG_KINDS]
        ops = sorted((o for o in self.ops if o.name.startswith(SEG_KERNEL)),
                     key=lambda o: o.t0)
        if len(mine) == len(ops):
            for o, k in zip(ops, mine):
                o.kind = k

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` in which some device op ran."""
        return sum(b - a for a, b in _union(
            [(max(o.t0, lo), min(o.t1, hi)) for o in self.ops]))

    def gaps(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The stretches of ``[lo, hi]`` in which no device op ran."""
        out, at = [], lo
        for a, b in _union([(max(o.t0, lo), min(o.t1, hi))
                            for o in self.ops]):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if hi > at:
            out.append((at, hi))
        return out


def _union(intervals):
    out: list = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_seconds(intervals) -> float:
    return sum(b - a for a, b in _union(intervals))


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0]


class Profiler:
    """``torch.profiler`` over the card's activity alone, started and
    stopped between two calls around the slice; its device ops are read
    afterwards straight from the profiler's results. Host events are not
    recorded: the profiler would record every torch call the host makes,
    slow the host under trace by as much, and hand back a trace too
    large to read within a run. One marker op, run alone between two
    synchronisations as the profiler starts, ties the trace's clock to
    ``time.monotonic``. Where the card's activity cannot be profiled (no
    card), the trace is empty."""

    def __init__(self):
        self._prof = None
        self._mark = (0.0, 0.0)

    def start(self) -> None:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)

        if not torch.cuda.is_available() or \
                ProfilerActivity.CUDA not in supported_activities():
            return
        mark = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             record_shapes=False, with_stack=False,
                             profile_memory=False)
        self._prof.__enter__()
        a = time.monotonic()
        mark.fill_(1)
        torch.cuda.synchronize()
        self._mark = (a, time.monotonic())

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self) -> Trace:
        if self._prof is None:
            return Trace()
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = sorted(
            ((e.start_ns(), e.duration_ns(), e.name())
             for e in self._prof.profiler.kineto_results.events()
             if e.device_type() == cuda), key=lambda e: e[0])
        self._prof = None
        if not events:
            raise RuntimeError("the profiler's trace lacks its marker op")
        return _read(events, sum(self._mark) / 2)


def _read(events, mark_mono: float) -> Trace:
    """The device ops after the marker, the first of ``events`` (``(start
    ns, duration ns, name)`` in order), on the monotonic clock: the
    marker ran inside the two synchronisations around it, and is put at
    their midpoint, ``mark_mono``."""
    base = events[0][0]
    tr = Trace()
    for t, d, name in events[1:]:
        a = mark_mono + (t - base) * 1e-9
        tr.ops.append(DeviceOp(short_name(name), a, a + d * 1e-9))
    return tr
