"""HTML timeline — per-process gantt of ops colored by completion type
(``jepsen/checker/timeline.clj``). Same CSS classes and layout scheme:
one column per process, one row per history index, invoke/ok/fail/info
colors, tooltip with latency.

The counterpart of the JAX package's ``report/timeline.py``: the same
string code, so both packages write the same bytes.
"""

from __future__ import annotations

import os
from html import escape
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.history import complete, index
from ..ops.op import Op

COL_WIDTH = 100
GUTTER_WIDTH = 106
HEIGHT = 16

STYLESHEET = """\
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; font: 10px monospace; }
.op.invoke  { background: #C1DEFF; }
.op.ok      { background: #B7FFB7; }
.op.fail    { background: #FFD4D5; }
.op.info    { background: #FEFFC1; }
"""


def pairs(history: Sequence[Op]) -> List[Tuple[Op, Optional[Op]]]:
    """[invoke, completion] pairs plus unmatched [info] singletons
    (``timeline.clj:33-52``)."""
    inflight: Dict = {}
    out: List[Tuple[Op, Optional[Op]]] = []
    for op in history:
        if op.type == "invoke":
            inflight[op.process] = op
        elif op.type == "info" and op.process not in inflight:
            out.append((op, None))
        else:
            inv = inflight.pop(op.process, None)
            if inv is not None:
                out.append((inv, op))
    return out


def process_index(history: Sequence[Op]) -> Dict:
    ps = sorted({op.process for op in history}, key=repr)
    return {p: i for i, p in enumerate(ps)}


def _pair_div(n_hist: int, pindex: Dict, start: Op,
              stop: Optional[Op]) -> str:
    op = stop or start
    left = GUTTER_WIDTH * pindex[start.process]
    top = HEIGHT * (start.index or 0)
    if stop is not None and stop.type == "info":
        height = HEIGHT * (n_hist + 1 - (start.index or 0))
    elif stop is not None:
        height = HEIGHT * max((stop.index or 0) - (start.index or 0), 1)
    else:
        height = HEIGHT
    title = ""
    if stop is not None and stop.time is not None and start.time is not None:
        title = f"{(stop.time - start.time) / 1e6:.0f} ms"
    body = escape(f"{op.process} {op.f} {start.value}")
    if stop is not None and stop.value != start.value:
        body += f"<br />{escape(repr(stop.value))}"
    style = (f"width:{COL_WIDTH}px;left:{left}px;top:{top}px;"
             f"height:{height}px")
    return (f'<div class="op {op.type}" style="{style}" '
            f'title="{escape(title)}">{body}</div>')


def html(test: dict, history: Sequence[Op],
         path: Optional[str] = None) -> str:
    """Render the timeline; optionally write it to ``path``
    (``timeline.clj:92-111``)."""
    h = complete(list(history), index=True)
    pindex = process_index(h)
    divs = "\n".join(_pair_div(len(h), pindex, a, b) for a, b in pairs(h))
    doc = (f"<html><head><style>{STYLESHEET}</style></head><body>"
           f"<h1>{escape(str(test.get('name', 'test')))}</h1>"
           f"<p>{escape(str(test.get('start-time', '')))}</p>"
           f'<div class="ops">{divs}</div></body></html>')
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(doc)
    return doc
