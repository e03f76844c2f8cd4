"""Performance graphs: raw latency points, latency quantiles, throughput.

The semantics of ``jepsen/checker/perf.clj`` — same bucketing (latency
quantiles q ∈ {0.5, 0.95, 0.99, 1} over 30 s windows, ``perf.clj:246-260``;
rates over 10 s buckets, ``:293-331``; nemesis activity shading,
``:189-201``) — rendered as native SVG instead of gnuplot PNGs.

The counterpart of the JAX package's ``report/perf.py``: the same string
code over :mod:`.svg`, so both packages write the same bytes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.op import Op
from .svg import SVG, Axes

TYPE_COLORS = {"ok": "#1a8f3c", "info": "#c28f00", "fail": "#c0392b"}
Q_COLORS = {0.5: "#1a8f3c", 0.95: "#c28f00", 0.99: "#c0392b", 1: "#7d3c98"}
F_SHAPES = ("circle", "square", "diamond")


def nanos_to_secs(t) -> float:
    return t / 1e9


def history_latencies(history: Sequence[Op]) -> List[Tuple[Op, Op]]:
    """Pair invocations with their completions, yielding
    ``(invoke, completion)`` tuples carrying times (the data behind
    ``util/history->latencies``, ``util.clj:553-587``). Unpaired
    invocations are dropped."""
    inflight: Dict = {}
    out = []
    for op in history:
        if op.type == "invoke":
            inflight[op.process] = op
        elif op.process in inflight:
            out.append((inflight.pop(op.process), op))
    return out


def nemesis_intervals(history: Sequence[Op],
                      final_time: Optional[float] = None
                      ) -> List[Tuple[float, float]]:
    """(start, stop) second pairs where the nemesis was active
    (``util.clj:589-606``): starts and stops pair up queue-wise, an
    unmatched start extends to the end of the history."""
    if final_time is None:
        times = [op.time for op in history if op.time is not None]
        final_time = nanos_to_secs(max(times)) if times else 0.0
    starts: List[Op] = []
    pairs: List[Tuple[float, float]] = []
    for op in history:
        if op.process != "nemesis":
            continue
        if op.f == "start":
            starts.append(op)
        elif op.f == "stop" and starts:
            first = starts.pop(0)
            if first.time is not None and op.time is not None:
                pairs.append((nanos_to_secs(first.time),
                              nanos_to_secs(op.time)))
    for op in starts:
        if op.time is not None:
            pairs.append((nanos_to_secs(op.time), final_time))
    return pairs


def bucket_time(dt: float, t: float) -> float:
    """Midpoint of the dt-wide bucket containing t (``perf.clj:15-25``)."""
    return (t // dt) * dt + dt / 2


def quantiles(qs: Sequence[float], xs: Sequence[float]) -> Dict[float, float]:
    """Floor-index quantiles, exactly as ``perf.clj:45-56``."""
    s = sorted(xs)
    if not s:
        return {}
    n = len(s)
    return {q: s[min(n - 1, int(n * q))] for q in qs}


def latencies_to_quantiles(dt: float, qs: Sequence[float],
                           points: Sequence[Tuple[float, float]]
                           ) -> Dict[float, List[Tuple[float, float]]]:
    """Per-window quantile curves from (time, latency) points
    (``perf.clj:58-80``)."""
    buckets: Dict[float, List[float]] = {}
    for t, l in points:
        buckets.setdefault(bucket_time(dt, t), []).append(l)
    out: Dict[float, List[Tuple[float, float]]] = {q: [] for q in qs}
    for bt in sorted(buckets):
        qv = quantiles(qs, buckets[bt])
        for q in qs:
            out[q].append((bt, qv[q]))
    return out


def _latency_points(history) -> Dict[str, Dict[str, List[Tuple[float, float]]]]:
    """f -> completion-type -> [(invoke-time-s, latency-ms)]."""
    out: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for inv, comp in history_latencies(history):
        if inv.time is None or comp.time is None:
            continue
        t = nanos_to_secs(inv.time)
        lat_ms = (comp.time - inv.time) / 1e6
        out.setdefault(str(inv.f), {}).setdefault(comp.type, []) \
           .append((t, max(lat_ms, 1e-3)))
    return out


def _shade_nemesis(svg: SVG, ax: Axes, history):
    for t0, t1 in nemesis_intervals(history):
        x0, x1 = ax.x(t0), ax.x(max(t1, t0))
        svg.rect(x0, ax.mt, max(x1 - x0, 1),
                 svg.height - ax.mt - ax.mb, fill="#000", opacity=0.06)


def _legend(svg: SVG, entries: List[Tuple[str, str]]):
    x = svg.width - 150
    y = 24
    for label, color in entries[:12]:
        svg.rect(x, y - 8, 9, 9, fill=color)
        svg.text(x + 13, y, label, size=9)
        y += 13


def point_graph(test: dict, history: Sequence[Op],
                path: Optional[str] = None) -> str:
    """Raw latency scatter (``perf.clj:220-244``); returns the SVG."""
    data = _latency_points(history)
    pts = [p for by_t in data.values() for ps in by_t.values() for p in ps]
    tmax = max((t for t, _ in pts), default=1.0)
    lmax = max((l for _, l in pts), default=1.0)
    svg = SVG(900, 400)
    ax = Axes(svg, (0, tmax * 1.02), (0.1, lmax * 1.5), log_y=True)
    _shade_nemesis(svg, ax, history)
    ax.frame("Time (s)", "Latency (ms)",
             f"{test.get('name', 'test')} latency")
    legend = []
    for f, by_type in sorted(data.items()):
        for typ, ps in sorted(by_type.items()):
            color = TYPE_COLORS.get(typ, "#555")
            for t, l in ps:
                svg.circle(ax.x(t), ax.y(l), 1.6, fill=color,
                           title=f"{f} {typ} {l:.2f} ms")
            legend.append((f"{f} {typ}", color))
    _legend(svg, legend)
    return _emit(svg, path)


def quantiles_graph(test: dict, history: Sequence[Op],
                    path: Optional[str] = None, dt: float = 30,
                    qs=(0.5, 0.95, 0.99, 1)) -> str:
    """Latency quantile curves per f over dt-second windows
    (``perf.clj:246-291``)."""
    data = _latency_points(history)
    svg = SVG(900, 400)
    all_pts = [p for by_t in data.values() for ps in by_t.values()
               for p in ps]
    tmax = max((t for t, _ in all_pts), default=1.0)
    lmax = max((l for _, l in all_pts), default=1.0)
    ax = Axes(svg, (0, tmax * 1.02), (0.1, lmax * 1.5), log_y=True)
    _shade_nemesis(svg, ax, history)
    ax.frame("Time (s)", "Latency (ms)",
             f"{test.get('name', 'test')} latency quantiles")
    legend = []
    for f, by_type in sorted(data.items()):
        pts = [p for ps in by_type.values() for p in ps]
        curves = latencies_to_quantiles(dt, qs, pts)
        for q in qs:
            color = Q_COLORS.get(q, "#555")
            curve = [(ax.x(t), ax.y(l)) for t, l in curves[q]]
            if curve:
                svg.polyline(curve, stroke=color)
            legend.append((f"{f} q{q}", color))
    _legend(svg, legend)
    return _emit(svg, path)


def rate_graph(test: dict, history: Sequence[Op],
               path: Optional[str] = None, dt: float = 10) -> str:
    """Completion rate by f and type over dt-second buckets, nemesis ops
    excluded (``perf.clj:293-331``)."""
    rates: Dict[Tuple[str, str], Dict[float, float]] = {}
    tmax = 1.0
    for op in history:
        if op.type == "invoke" or not isinstance(op.process, int):
            continue
        if op.time is None:
            continue
        t = nanos_to_secs(op.time)
        tmax = max(tmax, t)
        b = bucket_time(dt, t)
        key = (str(op.f), op.type)
        rates.setdefault(key, {})
        rates[key][b] = rates[key].get(b, 0.0) + 1.0 / dt
    rmax = max((v for m in rates.values() for v in m.values()), default=1.0)
    svg = SVG(900, 400)
    ax = Axes(svg, (0, tmax * 1.02), (0, rmax * 1.2))
    _shade_nemesis(svg, ax, history)
    ax.frame("Time (s)", "Throughput (hz)",
             f"{test.get('name', 'test')} rate")
    legend = []
    for (f, typ), m in sorted(rates.items()):
        color = TYPE_COLORS.get(typ, "#555")
        xs = []
        b = dt / 2
        while b <= tmax + dt / 2:
            xs.append((ax.x(b), ax.y(m.get(b, 0.0))))
            b += dt
        svg.polyline(xs, stroke=color)
        legend.append((f"{f} {typ}", color))
    _legend(svg, legend)
    return _emit(svg, path)


def _emit(svg: SVG, path: Optional[str]) -> str:
    out = svg.render()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(out)
    return out
