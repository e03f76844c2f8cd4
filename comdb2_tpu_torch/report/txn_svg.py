"""Counterexample rendering for the serializability checker — the
dependency cycle as a ring of txn nodes with typed edges, the
``render-analysis!`` role the linear checker's SVG plays
(``knossos/linear/report.clj``), but over the txn graph. The
counterpart of the JAX package's ``report/txn_svg.py``: the same
string code, so both packages write the same bytes."""

from __future__ import annotations

import math
from typing import Optional

_EDGE_COLOR = {"ww": "#1f77b4", "wr": "#2ca02c", "rw": "#d62728",
               "rt": "#7f7f7f", "?": "#000000"}


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def render_cycle(cex: dict, path: Optional[str] = None,
                 size: int = 460) -> str:
    """One SVG: cycle txns on a ring, arrows labeled with edge type
    and key. Returns the SVG text; writes it when ``path`` given."""
    steps = cex["cycle"]
    n = len(steps)
    cx = cy = size / 2
    r = size / 2 - 90
    pos = []
    for i in range(n):
        a = -math.pi / 2 + 2 * math.pi * i / max(n, 1)
        pos.append((cx + r * math.cos(a), cy + r * math.sin(a)))
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" font-family="monospace" font-size="11">',
        f'<text x="{cx}" y="18" text-anchor="middle" '
        f'font-size="14">{_esc(cex["class"])} cycle '
        f'({n} txns)</text>',
        '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
        'refX="7" refY="3" orient="auto">'
        '<path d="M0,0 L7,3 L0,6 z"/></marker></defs>',
    ]
    for i, s in enumerate(steps):
        x0, y0 = pos[i]
        x1, y1 = pos[(i + 1) % n]
        dx, dy = x1 - x0, y1 - y0
        d = math.hypot(dx, dy) or 1.0
        # pull endpoints off the node circles
        x0e, y0e = x0 + 24 * dx / d, y0 + 24 * dy / d
        x1e, y1e = x1 - 24 * dx / d, y1 - 24 * dy / d
        e = s["edge"]
        color = _EDGE_COLOR.get(e["type"], "#000")
        parts.append(
            f'<line x1="{x0e:.1f}" y1="{y0e:.1f}" x2="{x1e:.1f}" '
            f'y2="{y1e:.1f}" stroke="{color}" stroke-width="1.5" '
            'marker-end="url(#arr)"/>')
        mx, my = (x0e + x1e) / 2, (y0e + y1e) / 2
        label = e["type"] if e["key"] is None \
            else f'{e["type"]} k={e["key"]}'
        parts.append(
            f'<text x="{mx:.1f}" y="{my - 4:.1f}" fill="{color}" '
            f'text-anchor="middle">{_esc(label)}</text>')
    for i, s in enumerate(steps):
        x, y = pos[i]
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="22" fill="#fff" '
            'stroke="#333"/>')
        parts.append(
            f'<text x="{x:.1f}" y="{y + 4:.1f}" '
            f'text-anchor="middle">T{s["txn"]}</text>')
        meta = f'p{s["process"]} {s["status"]}'
        parts.append(
            f'<text x="{x:.1f}" y="{y + 36:.1f}" fill="#555" '
            f'text-anchor="middle">{_esc(meta)}</text>')
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as fh:
            fh.write(svg)
    return svg


__all__ = ["render_cycle"]
