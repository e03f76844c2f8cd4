"""Counterexample decode — a shortest dependency cycle in actual ops.

The engines return only WHICH vertices sit on a cycle, per layer (the
readback must stay small). Reconstruction runs on the host over the
labeled adjacency the inference pass already holds: pick the smallest
Adya layer with a cycle, BFS the shortest closed walk through one
cyclic vertex, and render every hop with its edge type, key, and the
real txn ops — the shape of the reference's ``:anomalies`` output
(elle's explain-cycle), so a human can replay the violation.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from .edges import TxnGraph
from .scc import layers_of

#: Adya class per smallest cyclic layer
LAYER_CLASS = ("G0", "G1c", "G2-item")


#: BFS start vertices tried before settling for the best cycle found
#: so far — decode runs inside the single-threaded service tick, and
#: an all-cyclic 4096-node realtime graph would otherwise pay one
#: full-graph BFS per cyclic vertex (the same stall class the
#: vectorized rt inference fixed). Any cycle is a valid
#: counterexample; minimality is best-effort.
MAX_BFS_STARTS = 8


def shortest_cycle(layer: np.ndarray, mask: np.ndarray) -> List[int]:
    """A short cycle through a masked vertex of one layer's
    adjacency: BFS from up to ``MAX_BFS_STARTS`` cyclic vertices,
    keeping the shortest closed walk seen."""
    best: List[int] = []
    for v in np.flatnonzero(mask)[:MAX_BFS_STARTS]:
        prev = {int(v): -1}
        q = deque([int(v)])
        found = None
        while q and found is None:
            u = q.popleft()
            for w in np.flatnonzero(layer[u]):
                w = int(w)
                if w == v:
                    found = u
                    break
                if w not in prev:
                    prev[w] = u
                    q.append(w)
        if found is None:
            continue                      # v reaches no cycle back
        path = [found]
        while path[-1] != v:
            path.append(prev[path[-1]])
        path.reverse()                    # v ... found, edge found->v
        if not best or len(path) < len(best):
            best = path
        if len(best) == 2:
            break                         # can't beat a 2-cycle
    return best


def explain_edge(graph: TxnGraph, a: int, b: int,
                 allowed_planes) -> dict:
    """The label of edge a->b restricted to the layer's planes. rt
    edges are label-free (edge inference skips ~n^2/2 label appends);
    their constant label is synthesized here."""
    for plane, key in graph.labels.get((a, b), ()):
        if plane in allowed_planes:
            return {"type": plane, "key": key}
    if "rt" in allowed_planes and graph.adj[3, a, b]:
        return {"type": "rt", "key": None}
    return {"type": "?", "key": None}


def decode(graph: TxnGraph, diag: np.ndarray,
           realtime: bool = False) -> Optional[dict]:
    """Engine output -> counterexample map, or None when acyclic.
    ``diag`` is the (3, n)-sliced cyclic-vertex mask (any padding
    already trimmed); ``realtime`` must match what the engine saw."""
    layer_ix = None
    for i in range(3):
        if diag[i].any():
            layer_ix = i
            break
    if layer_ix is None:
        return None
    rt = ("rt",) if realtime else ()
    allowed = (("ww",) + rt, ("ww", "wr") + rt,
               ("ww", "wr", "rw") + rt)[layer_ix]
    layers = layers_of(graph.adj, realtime=realtime)
    cycle = shortest_cycle(layers[layer_ix], diag[layer_ix])
    steps = []
    for i, a in enumerate(cycle):
        b = cycle[(i + 1) % len(cycle)]
        t = graph.txns[a]
        steps.append({
            "txn": a,
            "process": t.op.process,
            "status": t.status + (" (dirty)" if t.dirty else ""),
            "value": t.mops,
            "edge": explain_edge(graph, a, b, allowed),
        })
    return {"class": LAYER_CLASS[layer_ix], "cycle": steps}


def render_text(cex: dict) -> str:
    """One line per hop: ``T3 ok (p 1) [...] --rw(k=2)--> T5``."""
    lines = [f"{cex['class']} cycle, {len(cex['cycle'])} txns:"]
    steps = cex["cycle"]
    for i, s in enumerate(steps):
        nxt = steps[(i + 1) % len(steps)]["txn"]
        e = s["edge"]
        key = "" if e["key"] is None else f"(k={e['key']})"
        lines.append(
            f"  T{s['txn']} {s['status']} (p {s['process']}) "
            f"{list(s['value'])!r} --{e['type']}{key}--> T{nxt}")
    return "\n".join(lines)


__all__ = ["LAYER_CLASS", "shortest_cycle", "decode", "render_text"]
