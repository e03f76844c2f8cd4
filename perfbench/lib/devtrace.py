"""The traced run's device trace: ``torch.profiler`` over the window.

The profiler records the host's torch calls and the card's kernels,
copies and sets. The program's kernels launch through wrappers that name
each launch's kind (the segment search's ``seg_search`` for a single
history or a carry, ``seg_search_stream`` for a stream launch); the
harness records the kinds in launch order, and
:meth:`Trace.name_launches` gives each run of the kernel its kind. A named host range opened as the trace starts ties the
trace's clock to ``time.monotonic``, the clock of the program's spans
and of the harness's calls, so an idle stretch of the card can be put
down to what the host was doing then. The trace is written to a
temporary file under ``TMPDIR``, read, and deleted.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "perfbench.anchor"


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
    """``torch.profiler`` over host and device, started and stopped
    around the window."""

    def __init__(self):
        self._prof = None
        self._anchor = 0.0

    def start(self) -> None:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, supported_activities)

        acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                if a in supported_activities()]
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.__enter__()
        with record_function(ANCHOR):
            self._anchor = time.monotonic()

    def stop(self) -> Trace:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        tmp = tempfile.mkdtemp(prefix="perfbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                doc = json.load(fh)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self._prof = None
        return _read(doc, self._anchor)


def _read(doc: dict, anchor_mono: float) -> Trace:
    events = doc.get("traceEvents", [])
    anchor = next((e for e in events
                   if e.get("name") == ANCHOR and e.get("ph") == "X"),
                  None)
    if anchor is None:
        raise RuntimeError("the profiler's trace lacks its anchor range")
    base = float(anchor["ts"])

    def mono(ts_us: float) -> float:
        return anchor_mono + (float(ts_us) - base) * 1e-6

    tr = Trace()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        a = mono(e["ts"])
        tr.ops.append(DeviceOp(short_name(e.get("name", "?")), a,
                               a + float(e.get("dur", 0)) * 1e-6))
    return tr
