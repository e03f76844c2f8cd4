"""Host cycle engine — iterative Tarjan SCC over the layered graph.

The device engine (:mod:`.closure_torch`) and this module answer the
same question — "which vertices sit on a cycle, per Adya layer?" —
so either can back the checker and each is the other's oracle in
tests. Layers nest cumulatively (the Adya hierarchy):

- layer 0: ww                      (a cycle here is G0)
- layer 1: ww | wr                 (first cycle here is G1c)
- layer 2: ww | wr | rw            (first cycle here is G2-item)

With realtime edges enabled the rt plane is OR-ed into every layer
(strict serializability: cycles against realtime order count too).

Self-edges never exist (edge inference skips them), so a vertex is
cyclic iff its SCC has size >= 2.
"""

from __future__ import annotations

from typing import List

import numpy as np


def cyclic_vertices(adj: np.ndarray) -> np.ndarray:
    """Bool mask of vertices on some cycle of one adjacency matrix.
    Iterative Tarjan — this runs on 4096-node service-bucket graphs
    on a single CPU, so no recursion and adjacency lists built once
    via numpy."""
    n = adj.shape[0]
    heads: List[np.ndarray] = [np.flatnonzero(adj[i]) for i in range(n)]
    index = np.full(n, -1, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    cyclic = np.zeros(n, dtype=bool)
    stack: List[int] = []
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        # explicit DFS frames: (vertex, next-successor-ordinal)
        frames = [(root, 0)]
        while frames:
            v, si = frames[-1]
            if si == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            succ = heads[v]
            advanced = False
            while si < len(succ):
                w = int(succ[si])
                si += 1
                if index[w] == -1:
                    frames[-1] = (v, si)
                    frames.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            frames.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    cyclic[comp] = True
            if frames:
                pv = frames[-1][0]
                low[pv] = min(low[pv], low[v])
    return cyclic


def layers_of(adj: np.ndarray, realtime: bool = False) -> np.ndarray:
    """(3, n, n) cumulative Adya layers from the (4, n, n) planes."""
    ww, wr, rw, rt = (adj[i] for i in range(4))
    l0 = ww.copy()
    if realtime:
        l0 |= rt
    l1 = l0 | wr
    l2 = l1 | rw
    return np.stack([l0, l1, l2])


def cyclic_layers_host(adj: np.ndarray,
                       realtime: bool = False) -> np.ndarray:
    """(3, n) bool — per-layer cyclic-vertex masks, host engine."""
    layers = layers_of(adj, realtime)
    return np.stack([cyclic_vertices(layers[i]) for i in range(3)])


__all__ = ["cyclic_vertices", "layers_of", "cyclic_layers_host"]
