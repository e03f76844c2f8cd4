"""Counterexample SVG for failed linearizability analyses.

The counterpart of the JAX package's ``report/linear_svg.py``, over the
port's :class:`~..checker.linear.Analysis`; the same string code, so
both packages write the same bytes on the same input.

The role of ``knossos/linear/report.clj`` (``render-analysis!``,
``report.clj:629``): a process/time grid of the operations surrounding
the point where the frontier died, the crashing op highlighted, and the
surviving frontier's model states at death listed alongside.

The x axis uses the ops' REAL timestamps warped by density
(``warp-time-coordinates``, ``report.clj:385-410``): per unit region
the scale is that region's bar density over the maximum density, and
offsets accumulate — dead stretches of the timeline compress while the
contended region around the failure keeps full resolution. Histories
without timestamps fall back to rank coordinates (uniform density —
the same map with every region at scale 1).

ALL final paths are drawn SPATIALLY (``report.clj:385-647``): each
path is an arrow chain over the time grid, hopping from op bar to op
bar in linearization order with the resulting model state labeled on
each hop and the inconsistent step in red. Segments shared by several
paths are drawn ONCE (the ``merge-lines`` role, ``report.clj:300-351``
— final paths of one frontier share long prefixes, and overdrawing
them N times makes the plot unreadable). Paths whose ops fall outside
the window get per-path mini timelines beneath."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..ops.op import Op
from .svg import SVG

BAR = {"ok": "#B7FFB7", "fail": "#FFD4D5", "info": "#FEFFC1",
       None: "#C1DEFF"}
PATH_COLORS = ["#7A4DD8", "#0B7285", "#B8860B", "#C2255C",
               "#2F9E44", "#E8590C", "#1971C2", "#862E9C"]
ROW_H = 22
WINDOW = 40  # ops of context on each side of the failure


def warp_time_coordinates(span_times, tmin: float, tmax: float,
                          n_buckets: int = 96):
    """Density-warped time map (``report.clj:385-410``): returns
    ``f(t) -> [0, 1]`` monotone over ``[tmin, tmax]``. The axis is cut
    into unit regions; each region's scale is its bar-endpoint density
    over the max density, and offsets accumulate — so empty stretches
    collapse to slivers while the densest region keeps full width.

    ``span_times``: iterable of (process, t0, t1) bar extents (the
    per-process max count per region is the density, like the
    reference's ``coordinate-density``)."""
    if tmax <= tmin:
        return lambda t: 0.0
    unit = (tmax - tmin) / n_buckets
    counts: dict = {}
    for (p, t0, t1) in span_times:
        for t in (t0, t1):
            b = min(int((t - tmin) / unit), n_buckets - 1)
            key = (b, p)
            counts[key] = counts.get(key, 0) + 1
    density = [0] * n_buckets
    for (b, _p), c in counts.items():
        density[b] = max(density[b], c)
    dmax = max(max(density), 1)
    # empty regions keep a QUARTER-bar floor (the reference floors at
    # one bar, report.clj:399 — which barely compresses sparse
    # histories where dmax is 1-2; a smaller floor keeps the map
    # monotone and readable while actually collapsing dead time)
    scales = [max(d, 0.25) / dmax for d in density]
    offsets = [0.0] * (n_buckets + 1)
    for b in range(n_buckets):
        offsets[b + 1] = offsets[b] + scales[b]
    total = offsets[n_buckets] or 1.0

    def f(t: float) -> float:
        x = (t - tmin) / unit
        b = min(max(int(x), 0), n_buckets - 1)
        frac = min(max(x - b, 0.0), 1.0)
        return (offsets[b] + scales[b] * frac) / total

    return f


def render_analysis(history: Sequence[Op], analysis,
                    path: Optional[str] = None) -> str:
    """``analysis`` is a :class:`~..checker.linear.Analysis` (or any
    object with ``op_index`` and ``configs``)."""
    ops = list(history)
    fail_at = getattr(analysis, "op_index", None)
    lo = max(0, (fail_at or 0) - WINDOW)
    hi = min(len(ops), (fail_at or 0) + WINDOW)
    window = ops[lo:hi]

    # pair invocations with completions inside the window; keep BOTH
    # the invoked and the completed value — final paths describe ops
    # by their back-filled (completed) values, the bar label by the
    # invoked one. Coordinates are REAL op times (density-warped
    # below); rank is the fallback when the history carries none.
    times = [getattr(op, "time", None) for op in window]
    use_time = all(t is not None for t in times) and len(window) > 1 \
        and max(times) > min(times)
    coord = (lambda r: float(times[r])) if use_time else float
    spans = []  # (process, f, inv_value, comp_value, t0, t1, type)
    inflight = {}
    for rank, op in enumerate(window):
        if op.type == "invoke":
            inflight[op.process] = (rank, op)
        elif op.process in inflight:
            r0, inv = inflight.pop(op.process)
            spans.append((op.process, inv.f, inv.value, op.value,
                          coord(r0), coord(rank), op.type))
    end_t = coord(len(window) - 1) if window else 0.0
    for p, (r0, inv) in inflight.items():
        spans.append((p, inv.f, inv.value, inv.value, coord(r0),
                      end_t, None))

    procs = sorted({s[0] for s in spans}, key=repr)
    prow = {p: i for i, p in enumerate(procs)}

    width, left = 980, 90
    plot_w = width - left - 240
    tmin = min((s[4] for s in spans), default=0.0)
    tmax = max((s[5] for s in spans), default=1.0)
    warp = warp_time_coordinates(
        [(s[0], s[4], s[5]) for s in spans], tmin, tmax)

    def X(t: float) -> float:
        return left + warp(t) * plot_w

    paths = list(_paths_of(analysis))
    # anchor paths to grid bars up front: anchorable paths draw over
    # the grid, the rest get mini timelines (and size the canvas)
    anchors = _span_anchors(spans, prow, X)
    anchored, rest = [], []
    for p in paths:
        op_steps = [s for s in p
                    if isinstance(s, dict)
                    and isinstance(s.get("op"), dict)]
        pts = [_anchor_for(s, anchors) for s in op_steps]
        if pts and all(pts):
            anchored.append((p, op_steps, pts))
        else:
            rest.append(p)
    rest_lines = _layout_paths(rest, left, width - 30)
    height = (60 + ROW_H * max(len(procs), 1) + 16 * 12
              + (60 + 18 * len(rest_lines) if rest_lines else 20))
    svg = SVG(width, int(height))
    svg.text(width / 2, 16, "linearizability counterexample", size=13,
             anchor="middle")

    for p in procs:
        y = 40 + prow[p] * ROW_H
        svg.text(8, y + ROW_H / 2 + 3, f"proc {p}", size=10)
        svg.line(left, y + ROW_H / 2, width - 240, y + ROW_H / 2,
                 stroke="#eee")

    fail_t = (coord(fail_at - lo)
              if fail_at is not None and 0 <= fail_at - lo < len(window)
              else None)
    for (p, f, value, _cv, t0, t1, typ) in spans:
        y = 40 + prow[p] * ROW_H + 2
        x0 = X(t0)
        w = max(X(t1) - x0, 3)
        crashing = fail_t is not None and t0 <= fail_t <= t1 \
            and typ == "ok"
        svg.rect(x0, y, w, ROW_H - 6,
                 fill=BAR.get(typ, "#C1DEFF"),
                 stroke="#c0392b" if crashing else "#999",
                 title=f"{p} {f} {value!r} -> {typ or 'pending'}")
        label = f"{f} {value!r}" if value is not None else str(f)
        svg.text(x0 + 2, y + ROW_H - 10, label[: max(int(w / 6), 4)],
                 size=9)

    if fail_t is not None:
        x = X(fail_t)
        svg.line(x, 32, x, 40 + ROW_H * len(procs), stroke="#c0392b",
                 width=1.5, dash="4,3")
        svg.text(x, 30, "frontier died here", size=9, fill="#c0392b",
                 anchor="middle")

    # --- failed linearization orders, spatially ----------------------
    # (knossos/linear/report.clj:385-647): each path hops across the
    # op bars of the grid in linearization order; every hop is labeled
    # with the model state it produced and the inconsistent step is
    # red. Final paths of one frontier share long prefixes, so shared
    # SEGMENTS (same endpoints + same resulting state) draw exactly
    # once — the merge-lines role (report.clj:300-351) — which is what
    # keeps "render ALL paths" readable. Paths whose ops can't all be
    # anchored to a bar in the window fall back to a per-path mini
    # timeline below.
    overlaid = 0
    drawn_segs: set = set()
    drawn_marks: set = set()
    if anchored:
        # hover interactivity (the reference highlights paths on
        # hover, report.clj:540+): each path carries an invisible
        # thick hit-polyline through ALL its anchors; hovering it
        # halos the WHOLE path — which also disambiguates segments
        # that several paths share (drawn once below)
        svg.style(".cpath .hit{stroke-opacity:0}"
                  ".cpath:hover .hit{stroke-opacity:.3}")
    hit_bands = []            # emitted AFTER the visible marks: the
    for pi, (p, op_steps, pts) in enumerate(anchored):
        color = PATH_COLORS[pi % len(PATH_COLORS)]
        if len(pts) >= 2:     # hit band must be topmost or hovering
            order = " -> ".join(  # exactly ON a mark never triggers it
                _step_label(s.get("op"), s.get("model"))
                for s in op_steps)
            hit_bands.append(
                (pts, color, f"linearization order {pi}: {order}"))
        # a path may start with string "prologue" steps describing the
        # entry state ("(state before N returns)")
        prologue = [s for s in p if s not in op_steps]
        overlaid += 1
        prev = None
        for si, (step, (ax, ay)) in enumerate(zip(op_steps, pts)):
            dead = step.get("model") == "inconsistent"
            state = _state_label(step.get("model"))
            if prev is None:
                entry = ("from " + _state_label(
                    prologue[-1].get("model")) if prologue else None)
                ekey = (round(ax), round(ay), entry)
                if entry and ekey not in drawn_marks:
                    # entry state from the prologue, at the first dot;
                    # distinct entry states at the same anchor stack
                    stacked = sum(1 for (mx, my, t) in drawn_marks
                                  if (mx, my) == ekey[:2]
                                  and isinstance(t, str)
                                  and t.startswith("from "))
                    drawn_marks.add(ekey)
                    svg.text(ax, ay - 9 - 9 * stacked, entry,
                             size=8, fill=color, anchor="middle")
            else:
                px, py_ = prev
                seg = (round(px), round(py_), round(ax), round(ay),
                       state)
                if seg not in drawn_segs:
                    drawn_segs.add(seg)
                    svg.line(px, py_, ax, ay,
                             stroke="#c0392b" if dead else color,
                             width=1.4 if dead else 1.1)
            mark = (round(ax), round(ay), state)
            if mark not in drawn_marks:
                drawn_marks.add(mark)
                # the model state this hop produced, beside the dot
                svg.text(ax + 5, ay - 5, state, size=8,
                         fill="#c0392b" if dead else color)
                svg.circle(ax, ay, 3.4 if dead else 2.6,
                           fill="#c0392b" if dead else color,
                           title=f"{step.get('op')!r} -> "
                                 f"{step.get('model')!r}")
            prev = (ax, ay)

    for pts, color, title in hit_bands:
        svg.open_group(**{"class": "cpath"})
        # opacity=0 as a PRESENTATION attribute too: renderers that
        # ignore embedded CSS must not draw a thick opaque band
        # (browser :hover CSS still overrides it)
        svg.polyline(pts, stroke=color, width=7, cls="hit", opacity=0,
                     title=title)
        svg.close_group()

    y = 52 + ROW_H * max(len(procs), 1)
    if overlaid:
        svg.text(left, y, f"{overlaid} failed linearization orders "
                          "drawn over the grid — each hop is labeled "
                          "with the model state it produced; the red "
                          "hop made the model inconsistent",
                 size=9, fill="#555")
        y += 14

    svg.text(left, y, "surviving configs at death:", size=10)
    configs = list(getattr(analysis, "configs", []) or [])[:10]
    for i, cfg in enumerate(configs):
        svg.text(left, y + 14 + 13 * i, f"  {cfg}", size=9, fill="#444")
    if not configs:
        svg.text(left, y + 14, "  (none recorded)", size=9, fill="#444")
    y += 20 + 13 * max(len(configs), 1)

    # per-path mini timelines for unanchorable paths
    if rest_lines:
        svg.text(left, y, "failed linearization orders "
                          "(each order dies at the red step):",
                 size=10)
        y += 8
        for li, line in enumerate(rest_lines):
            py = y + 18 * (li + 1)
            for (x, w, label, dead, arrow, title) in line:
                svg.rect(x, py - 11, w, 15,
                         fill="#FFD4D5" if dead else "#EDF3FF",
                         stroke="#c0392b" if dead else "#aab",
                         title=title)
                svg.text(x + 3, py, label, size=9,
                         fill="#c0392b" if dead else "#223")
                if arrow:
                    svg.line(x + w + 2, py - 4, x + w + 11, py - 4,
                             stroke="#888")

    out = svg.render()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(out)
    return out


def _span_anchors(spans, prow, X):
    """(process, f, value) -> (x, y) canvas anchor at the CENTER of
    that op's bar in the grid; registered under both the invoked and
    the completed value (final paths use back-filled values). Pending
    (still-open) spans win over completed ones with the same
    signature: final paths linearize pending calls."""
    anchors = {}          # key -> (x, y, was_pending)
    for (p, f, inv_v, comp_v, t0, t1, typ) in spans:
        y = 40 + prow[p] * ROW_H + (ROW_H - 6) / 2 + 2
        x = (X(t0) + X(t1)) / 2
        for value in {repr(inv_v), repr(comp_v)}:
            key = (repr(p), repr(f), value)
            prev = anchors.get(key)
            # pending beats completed (final paths linearize pending
            # calls); among equals the LATEST occurrence wins — a
            # retried identical op's path step refers to the most
            # recent call, not the first
            if prev is None or typ is None or not prev[2]:
                anchors[key] = (x, y, typ is None)
    return {k: (x, y) for k, (x, y, _) in anchors.items()}


def _anchor_for(step, anchors):
    op_d = step.get("op") if isinstance(step, dict) else None
    if not isinstance(op_d, dict):
        return None
    return anchors.get((repr(op_d.get("process")), repr(op_d.get("f")),
                        repr(op_d.get("value"))))


def _state_label(model) -> str:
    return "⊥" if model == "inconsistent" else str(model)[:18]


def _paths_of(analysis):
    """Final paths from an Analysis (info dict) or a plain mapping."""
    info = getattr(analysis, "info", None)
    if isinstance(info, dict) and info.get("paths"):
        return info["paths"]
    if isinstance(analysis, dict):
        return analysis.get("paths", [])
    return getattr(analysis, "paths", []) or []


def _layout_paths(paths, left: float, right: float):
    """Pre-layout path chips into wrapped display lines. Each line is a
    list of (x, w, label, dead, draw_arrow, title) chips; a path whose
    chips exceed the canvas width continues (indented) on the next
    line."""
    lines = []
    for p in paths:
        line = []
        x = left
        for si, step in enumerate(p):
            op_d = step.get("op")
            model = step.get("model")
            dead = model == "inconsistent"
            label = _step_label(op_d, model)
            w = 7 + 5.2 * len(label)
            if x + w > right and line:      # wrap; keep chip intact
                lines.append(line)
                line = []
                x = left + 24
            arrow = si < len(p) - 1
            line.append((x, w, label, dead, arrow,
                         f"{op_d!r} -> {model!r}"))
            x += w + 14
        if line:
            lines.append(line)
    return lines


def _step_label(op_d, model) -> str:
    if isinstance(op_d, dict):
        op_s = f"{op_d.get('f')} {op_d.get('value')!r}"
    else:
        op_s = str(op_d)
    m_s = "⊥" if model == "inconsistent" else str(model)
    return f"{op_s} → {m_s}"[:46]
