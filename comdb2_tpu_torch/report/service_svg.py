"""Service-run latency/rate timeline — queue-wait vs device-time.

The ``jepsen.checker.perf``-style graph (:mod:`.perf`) for the
verifier daemon: instead of history ops, the input is the per-request
stage records the service core accumulates
(``VerifierCore.timeline_records()`` — one row per completed request
with the STAGES attribution, plus overload/deadline/degrade event
marks). Each ``dt``-second window renders the MEAN per-stage latency
as a stacked area — queue-wait at the bottom, then host-pack, device,
finalize — so the p99-vs-p50 story is visible at a glance: a fat
queue-wait band is an admission problem, a fat device band is a
dispatch problem. Overload/deadline events draw as vertical markers;
the request rate rides as a scaled overlay line (its peak is printed
in the legend — stage latency owns the y axis).

Written to ``<store>/service/timeline.svg`` by the daemon's artifact
pass and linked from the store web index (:mod:`..harness.web`).

The counterpart of the JAX package's ``report/service_svg.py``: the
same SVG bytes on the same records.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from .svg import SVG, Axes

#: stacking order bottom-up — matches service.core.STAGES
STAGE_ORDER = ("queue_wait_ms", "host_pack_ms", "device_ms",
               "finalize_ms")
STAGE_COLORS = {"queue_wait_ms": "#c28f00", "host_pack_ms": "#2471a3",
                "device_ms": "#1a8f3c", "finalize_ms": "#7d3c98"}
EVENT_COLORS = {"overload": "#c0392b", "deadline": "#e67e22",
                "host_degraded": "#2c3e50", "engine_error": "#c0392b"}
RATE_COLOR = "#555"


def _windows(records: Sequence[dict], dt: float):
    """Window index -> per-stage latency sums + request count."""
    by_w: Dict[int, dict] = {}
    for r in records:
        w = int(r.get("t", 0.0) // dt)
        acc = by_w.setdefault(
            w, {"n": 0, **{s: 0.0 for s in STAGE_ORDER}})
        acc["n"] += 1
        stages = r.get("stages") or {}
        for s in STAGE_ORDER:
            acc[s] += float(stages.get(s, 0.0))
    return by_w


def render_service_timeline(records: Sequence[dict],
                            events: Sequence[dict] = (),
                            path: Optional[str] = None,
                            dt: float = 1.0,
                            title: str = "verifier service") -> str:
    """Render the stacked stage-latency timeline; returns the SVG
    text (and writes it when ``path`` is given)."""
    svg = SVG(900, 400)
    by_w = _windows(records, dt)
    tmax = max([ (w + 1) * dt for w in by_w ]
               + [e.get("t", 0.0) for e in events] + [1.0])
    stacks: Dict[int, List[float]] = {}
    ymax = 1.0
    for w, acc in by_w.items():
        tot, cum = 0.0, []
        for s in STAGE_ORDER:
            tot += acc[s] / max(acc["n"], 1)
            cum.append(tot)
        stacks[w] = cum
        ymax = max(ymax, tot)
    rmax = max([acc["n"] / dt for acc in by_w.values()] + [1.0])
    ax = Axes(svg, (0, tmax * 1.02), (0, ymax * 1.25))
    ax.frame("Time since boot (s)", "Latency (ms, mean per window)",
             f"{title}: per-stage latency + rate")
    ws = sorted(stacks)
    # stacked areas bottom-up: each band is the polygon between the
    # previous cumulative curve and this stage's
    if ws:
        xs = [w * dt + dt / 2 for w in ws]
        prev = [0.0] * len(ws)
        for i, s in enumerate(STAGE_ORDER):
            cur = [stacks[w][i] for w in ws]
            pts = ([(ax.x(x), ax.y(v)) for x, v in zip(xs, cur)]
                   + [(ax.x(x), ax.y(v))
                      for x, v in zip(reversed(xs), reversed(prev))])
            poly = " ".join(f"{round(x, 2)},{round(y, 2)}"
                            for x, y in pts)
            svg.elem("polygon", points=poly, fill=STAGE_COLORS[s],
                     fill_opacity=0.7, stroke="none")
            prev = cur
        # request rate, scaled into the top 40% of the plot (its own
        # unit — the legend carries the peak)
        rate_pts = [(ax.x(x), ax.y(by_w[w]["n"] / dt / rmax
                                   * ymax * 0.4))
                    for x, w in zip(xs, ws)]
        svg.polyline(rate_pts, stroke=RATE_COLOR, width=1.2,
                     title="req/s (scaled)")
    for e in events:
        x = ax.x(e.get("t", 0.0))
        svg.line(x, ax.mt, x, svg.height - ax.mb,
                 stroke=EVENT_COLORS.get(e.get("event"), "#999"),
                 width=1, dash="4,3")
    legend = ([(s.replace("_ms", ""), STAGE_COLORS[s])
               for s in STAGE_ORDER]
              + [(f"req/s (peak {rmax:.1f})", RATE_COLOR)]
              + [(k, c) for k, c in EVENT_COLORS.items()
                 if any(e.get("event") == k for e in events)])
    x0, y0 = svg.width - 170, 24
    for label, color in legend[:10]:
        svg.rect(x0, y0 - 8, 9, 9, fill=color)
        svg.text(x0 + 13, y0, label, size=9)
        y0 += 13
    out = svg.render()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(out)
    return out


__all__ = ["STAGE_ORDER", "render_service_timeline"]
