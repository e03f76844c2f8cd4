"""Txn-granularity shrink — minimal dependency cycles on the tensor cores.

The counterpart of the JAX package's ``shrink/txn.py``. For
serializability violations the natural drop unit is the whole
transaction, and the evidence is the inferred dependency graph: a cycle
among kept txns survives a restriction exactly when every txn on it is
kept, so "is this candidate still invalid" is "is the sliced
sub-adjacency still cyclic", a batched
:func:`~..txn.closure_torch.closure_diag_batch` call (bf16
``torch.matmul`` squarings), one device call per pow2-N bucket. Edges
are inferred ONCE from the full history (real evidence); candidates
never re-run the host inference pass, and nothing is caught around
the device.

The decoded counterexample cycle seeds the search (restricting to its
txns provably preserves the cycle), the ddmin ladder + greedy endgame
then strip chords and shortcut sub-cycles, and the final greedy round
certifies 1-minimality: removing any remaining txn leaves the
subgraph acyclic.

Invalid-but-acyclic seeds (direct anomalies only — G1a, duplicates)
have no cycle to minimize: the anomaly records already name the
culprit txns, so the shrinker answers immediately with those, flagged
NOT 1-minimal-certified.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..ops.op import Op
from ..txn.check import verdict_map
from ..txn.counterexample import LAYER_CLASS, decode
from ..txn.edges import READ, TXN_N_FLOOR, TxnGraph, infer_edges
from ..utils import next_pow2, resolve_device
from .core import DdminEngine, SeedVerdictError, ShrinkResult


class TxnShrinker(DdminEngine):
    """Step-driven minimal-cycle shrinker (see module docstring and
    :class:`~.core.DdminEngine`). Atom ids are node ids of the inferred
    :class:`~..txn.edges.TxnGraph`. ``device``: ``None`` means
    ``cuda``."""

    checker = "txn"

    def __init__(self, history: Sequence[Op] = (), *,
                 realtime: bool = False,
                 graph: Optional[TxnGraph] = None,
                 max_batch: int = 64,
                 round_cap: Optional[int] = None,
                 mesh=None, device=None):
        super().__init__(round_cap)
        self.device = resolve_device(device)
        self.ops_list = list(history)
        self.realtime = realtime
        self.graph = graph if graph is not None \
            else infer_edges(self.ops_list, realtime=realtime)
        self.max_batch = max_batch
        self.mesh = mesh
        self.extra: dict = {}

    # -- candidate plumbing --------------------------------------------

    def _sub_adj(self, ids: List[int], n_pad: int) -> np.ndarray:
        idx = np.asarray(ids, np.int64)
        sub = self.graph.adj[:, idx[:, None], idx[None, :]]
        if not self.realtime:
            sub = sub.copy()
            sub[3] = False
        out = np.zeros((sub.shape[0], n_pad, n_pad), bool)
        out[:, :len(ids), :len(ids)] = sub
        return out

    def _test(self, cand_sets: List[List[int]]) -> np.ndarray:
        """bool[B]: candidate txn subsets whose restricted dependency
        subgraph is still cyclic. ONE ``closure_diag_batch`` call per
        pow2-N bucket chunk (batch axis pow2-padded with copies), never
        a per-candidate ``closure_diag`` loop."""
        from ..txn.closure_torch import closure_diag_batch

        out = np.zeros(len(cand_sets), bool)
        self.counters["candidates"] = (
            self.counters.get("candidates", 0) + len(cand_sets))
        groups: dict = {}
        for i, ids in enumerate(cand_sets):
            if len(ids) < 2:
                continue   # self-edges never enter the graph: acyclic
            groups.setdefault(
                next_pow2(len(ids), TXN_N_FLOOR), []).append(i)
        for n_pad, idxs in sorted(groups.items()):
            for lo in range(0, len(idxs), self.max_batch):
                chunk = idxs[lo:lo + self.max_batch]
                adjs = [self._sub_adj(cand_sets[i], n_pad)
                        for i in chunk]
                b = next_pow2(len(adjs))
                adjs = adjs + [adjs[0]] * (b - len(adjs))
                diag = closure_diag_batch(np.stack(adjs),
                                          mesh=self.mesh,
                                          device=self.device)
                out[chunk] = np.asarray(diag)[:len(chunk)].any(
                    axis=(1, 2))
                self.counters["dispatches"] = (
                    self.counters.get("dispatches", 0) + 1)
        return out

    # -- the rounds ----------------------------------------------------

    def _seed_round(self) -> None:
        from ..txn.closure_torch import closure_diag_batch

        self.rounds += 1
        g = self.graph
        cex = None
        if g.n and g.adj.any():
            adj = g.padded()
            if not self.realtime:
                adj = adj.copy()
                adj[3] = False
            diag = closure_diag_batch(adj[None], device=self.device)[0]
            self.counters["dispatches"] += 1
            cex = decode(g, np.asarray(diag)[:, :g.n],
                         realtime=self.realtime)
        verdict = verdict_map(g, cex)["valid?"]
        if verdict is not False:
            self.error = SeedVerdictError(
                verdict, f"seed verdict is {verdict!r} — only INVALID "
                         "histories shrink")
            self.phase = "done"
            return
        if cex is None:
            # invalid via direct anomalies alone (G1a, duplicates,
            # unexpected-value): no cycle to minimize — the anomaly
            # records already name the culprits
            self.cur = sorted(self._anomaly_nodes())
            self.extra["note"] = ("direct-anomaly seed: no dependency "
                                  "cycle to minimize")
            self.extra["anomalies"] = [
                a["name"] for a in g.anomalies if a["name"] != "malformed"]
            self.phase = "done"
            return
        self.extra["seed_class"] = cex["class"]
        self.cur = sorted({s["txn"] for s in cex["cycle"]})
        self.phase = "ddmin" if len(self.cur) > 2 else "greedy"

    def _anomaly_nodes(self) -> set:
        """Best-effort node ids referenced by the direct anomalies
        (their txn fields mix node ids and original history indices;
        resolve through ``Txn.index`` first, raw node id second)."""
        g = self.graph
        by_orig = {t.index: j for j, t in enumerate(g.txns)}
        nodes: set = set()
        for a in g.anomalies:
            if a["name"] == "malformed":
                continue
            refs = []
            if isinstance(a.get("txn"), int):
                refs.append(a["txn"])
            refs += [x for x in a.get("txns", ()) if isinstance(x, int)]
            for x in refs:
                if x in by_orig:
                    nodes.add(by_orig[x])
                elif 0 <= x < g.n:
                    nodes.add(x)
        return nodes or set(range(g.n))

    # -- results -------------------------------------------------------

    def _evidence_txns(self) -> List[int]:
        """Reader txns whose observations SUPPLY the kept cycle's
        edges. The dependency evidence of a list-append graph lives in
        reads — each key's version order is recovered from its longest
        committed read — and that reader need not sit ON the cycle
        (e.g. a final audit read). Without it the emitted sub-history
        would re-check VALID standalone. One txn per cycle-edge key
        (the longest reader), so the addition is bounded by the
        cycle's key count; kept txns that already carry the read add
        nothing."""
        kept = set(self.cur)
        keys = set()
        for a in self.cur:
            for b in self.cur:
                if a != b:
                    for _plane, key in self.graph.labels.get((a, b),
                                                             ()):
                        if key is not None:
                            keys.add(key)
        out = set()
        for k in keys:
            order = tuple(self.graph.orders.get(k, ()))
            if not order:
                continue
            for j, t in enumerate(self.graph.txns):
                if t.status != "ok":
                    continue
                if any(f == READ and mk == k and v is not None
                       and tuple(v) == order
                       for f, mk, v in t.mops):
                    if j not in kept:
                        out.add(j)
                    break
        return sorted(out)

    def _final_class(self) -> Optional[str]:
        """Adya class of the minimal subgraph (smallest cyclic layer,
        host-side — the set is tiny by now)."""
        if len(self.cur) < 2:
            return None
        from ..txn.scc import cyclic_layers_host

        idx = np.asarray(self.cur, np.int64)
        sub = self.graph.adj[:, idx[:, None], idx[None, :]]
        diag = cyclic_layers_host(sub, realtime=self.realtime)
        for i in range(3):
            if diag[i].any():
                return LAYER_CLASS[i]
        return None

    def result(self, partial: bool = False) -> ShrinkResult:
        g = self.graph
        evidence = ([] if self.error is not None
                    else self._evidence_txns())
        rows: List[int] = []
        for j in list(self.cur) + evidence:
            t = g.txns[j]
            for at in (t.invoke_at, t.complete_at):
                if at is not None and 0 <= at < len(self.ops_list):
                    rows.append(at)
        rows = sorted(set(rows))
        ops = [self.ops_list[i].with_(index=k)
               for k, i in enumerate(rows)]
        extra = dict(self.extra)
        # `txns` is the 1-minimal CYCLE set (what the certificate
        # covers); `evidence_txns` are the reader txns included in the
        # emitted ops so minimal.edn re-checks INVALID standalone
        extra["txns"] = list(self.cur)
        if evidence:
            extra["evidence_txns"] = evidence
        cls = self._final_class()
        if cls is not None:
            extra["anomaly_class"] = cls
        return ShrinkResult(
            checker=self.checker,
            valid=(False if self.phase != "seed"
                   and self.error is None else "unknown"),
            ops=ops,
            seed_ops=len(self.ops_list) or g.n,
            n_ops=len(ops) or len(self.cur),
            rounds=self.rounds,
            candidates=self.counters["candidates"],
            dispatches=self.counters["dispatches"],
            one_minimal=self.one_minimal and not partial,
            partial=partial, extra=extra)


__all__ = ["TxnShrinker"]
