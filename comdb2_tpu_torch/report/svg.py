"""Minimal SVG document writer for the reporting layer.

The counterpart of the JAX package's ``report/svg.py``: the same string
code, so both packages write the same bytes.

The reference shells out to gnuplot for PNGs (``checker/perf.clj``) and
hand-writes SVG for counterexamples (``knossos/linear/report.clj``); we
render everything as self-contained SVG with no external processes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape, quoteattr


def _attrs(attrs: dict) -> str:
    return " ".join(f"{k.replace('_', '-')}={quoteattr(str(v))}"
                    for k, v in attrs.items() if v is not None)


class SVG:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.parts: List[str] = []

    def elem(self, tag: str, body: Optional[str] = None, **attrs):
        a = _attrs(attrs)
        if body is None:
            self.parts.append(f"<{tag} {a}/>")
        else:
            self.parts.append(f"<{tag} {a}>{body}</{tag}>")

    def line(self, x1, y1, x2, y2, stroke="#333", width=1, dash=None):
        self.elem("line", x1=round(x1, 2), y1=round(y1, 2),
                  x2=round(x2, 2), y2=round(y2, 2), stroke=stroke,
                  stroke_width=width, stroke_dasharray=dash)

    def rect(self, x, y, w, h, fill="#000", opacity=None, stroke=None,
             title=None):
        body = f"<title>{escape(title)}</title>" if title else None
        self.elem("rect", body, x=round(x, 2), y=round(y, 2),
                  width=round(w, 2), height=round(h, 2), fill=fill,
                  fill_opacity=opacity, stroke=stroke)

    def circle(self, cx, cy, r, fill="#000", title=None):
        body = f"<title>{escape(title)}</title>" if title else None
        self.elem("circle", body, cx=round(cx, 2), cy=round(cy, 2),
                  r=r, fill=fill)

    def text(self, x, y, s, size=11, fill="#111", anchor="start",
             family="monospace"):
        self.elem("text", escape(str(s)), x=round(x, 2), y=round(y, 2),
                  font_size=size, fill=fill, text_anchor=anchor,
                  font_family=family)

    def polyline(self, pts: Sequence[Tuple[float, float]], stroke="#333",
                 width=1.5, title=None, opacity=None, cls=None):
        p = " ".join(f"{round(x, 2)},{round(y, 2)}" for x, y in pts)
        body = f"<title>{escape(title)}</title>" if title else None
        attrs = {"points": p, "fill": "none", "stroke": stroke,
                 "stroke_width": width, "stroke_opacity": opacity}
        if cls:
            attrs["class"] = cls
        self.elem("polyline", body, **attrs)

    def style(self, css: str) -> None:
        """Embed a stylesheet (hover interactivity — the reference's
        counterexample SVGs highlight on hover, ``report.clj:540+``)."""
        self.parts.append(f"<style>{css}</style>")

    def open_group(self, **attrs) -> None:
        self.parts.append(f"<g {_attrs(attrs)}>")

    def close_group(self) -> None:
        self.parts.append("</g>")

    def render(self) -> str:
        return (f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'width="{self.width}" height="{self.height}" '
                f'viewBox="0 0 {self.width} {self.height}">'
                f'<rect width="100%" height="100%" fill="white"/>'
                + "".join(self.parts) + "</svg>")


class Axes:
    """Linear (or log-y) data→pixel mapping with margins and ticks."""

    def __init__(self, svg: SVG, x_range, y_range, margin=(50, 15, 20, 35),
                 log_y: bool = False):
        self.svg = svg
        self.ml, self.mr, self.mt, self.mb = margin
        self.x0, self.x1 = x_range
        self.y0, self.y1 = y_range
        self.log_y = log_y
        if log_y:
            self.y0 = max(self.y0, 1e-9)
            self.y1 = max(self.y1, self.y0 * 10)
        if self.x1 <= self.x0:
            self.x1 = self.x0 + 1
        if self.y1 <= self.y0:
            self.y1 = self.y0 + 1

    def x(self, v) -> float:
        w = self.svg.width - self.ml - self.mr
        return self.ml + w * (v - self.x0) / (self.x1 - self.x0)

    def y(self, v) -> float:
        h = self.svg.height - self.mt - self.mb
        if self.log_y:
            v = max(v, self.y0)
            frac = ((math.log10(v) - math.log10(self.y0))
                    / (math.log10(self.y1) - math.log10(self.y0)))
        else:
            frac = (v - self.y0) / (self.y1 - self.y0)
        return self.svg.height - self.mb - h * frac

    def frame(self, xlabel="", ylabel="", title=""):
        s = self.svg
        s.line(self.ml, s.height - self.mb, s.width - self.mr,
               s.height - self.mb)
        s.line(self.ml, self.mt, self.ml, s.height - self.mb)
        if title:
            s.text(s.width / 2, 14, title, size=13, anchor="middle")
        if xlabel:
            s.text(s.width / 2, s.height - 6, xlabel, anchor="middle")
        if ylabel:
            s.text(12, self.mt - 4, ylabel, size=10)
        for v in self._ticks_x():
            s.line(self.x(v), s.height - self.mb, self.x(v),
                   s.height - self.mb + 4)
            s.text(self.x(v), s.height - self.mb + 16, _fmt(v), size=9,
                   anchor="middle")
        for v in self._ticks_y():
            s.line(self.ml - 4, self.y(v), self.ml, self.y(v))
            s.text(self.ml - 6, self.y(v) + 3, _fmt(v), size=9,
                   anchor="end")

    def _ticks_x(self, n=8):
        return _nice_ticks(self.x0, self.x1, n)

    def _ticks_y(self, n=6):
        if self.log_y:
            lo = math.floor(math.log10(self.y0))
            hi = math.ceil(math.log10(self.y1))
            return [10.0 ** e for e in range(int(lo), int(hi) + 1)]
        return _nice_ticks(self.y0, self.y1, n)


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.0e}"
    if float(v).is_integer():
        return str(int(v))
    return f"{v:.2g}"


def _nice_ticks(lo: float, hi: float, n: int) -> List[float]:
    span = hi - lo
    if span <= 0:
        return [lo]
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    start = math.ceil(lo / step) * step
    out = []
    v = start
    while v <= hi + step * 1e-9:
        out.append(round(v, 10))
        v += step
    return out
