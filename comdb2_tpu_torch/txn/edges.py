"""Dependency-edge inference over list-append txn histories.

This is the host half of the serializability checker (the Elle move,
elle/list_append.clj): because every read returns the key's WHOLE
list, the longest committed read of a key IS its version order, and
every other read must be a prefix of it. From the recovered orders:

- ``ww``  w1 -> w2 when w1's append immediately precedes w2's in a
  key's version order (write dependency).
- ``wr``  w -> t when txn t read a list whose last element was
  appended by w (read dependency).
- ``rw``  t -> w when w appended the element immediately after the
  last one t observed — including the first element after an empty
  read (anti-dependency).
- ``rt``  (optional) t1 -> t2 when t1 completed before t2 was
  invoked (realtime order, for strict serializability).

Direct (non-cycle) anomalies are flagged here too, Adya names:

- ``G1a`` — a committed read observed a value appended by a txn that
  reported :fail (aborted read; the ``-R`` dirty-commit control's
  signature). The dirty txn's effects are real — it joins the graph
  as a node so cycles through it are found.
- ``duplicate`` — one value appears twice in a read, or two txns
  appended the same (key, value) (the ``-D`` no-dedup control).
- ``incompatible-order`` — two committed reads of one key disagree
  on the prefix order (torn version order; e.g. split-brain).

The adjacency output is a ``(4, N, N)`` bool array (ww, wr, rw, rt
planes) padded to a pow2 txn count (floor ``TXN_N_FLOOR``), the JAX
package's bucketing convention, which the device closure engine
(:mod:`.closure_torch`) keeps so both packages see the same shapes.

A copy of the JAX package's ``txn/edges.py``, with no change of
behaviour: the same history gives the same arrays in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.op import Op
from ..utils import next_pow2

#: pow2 floor of the padded txn-count axis (bucketing convention)
TXN_N_FLOOR = 16

#: adjacency planes, in order
PLANES = ("ww", "wr", "rw", "rt")

APPEND = "append"
READ = "r"


def micro_ops(value: Any) -> Tuple[Tuple[Any, ...], ...]:
    """Normalize a txn op value to a tuple of ``(f, k, v)`` micro-ops.
    EDN round-trips deliver nested tuples already; lists are accepted
    for hand-built histories. Raises ``ValueError`` on malformed
    micro-ops (the service answers those ``bad-request``)."""
    if value is None:
        return ()
    out = []
    for m in value:
        m = tuple(m)
        if len(m) != 3 or m[0] not in (APPEND, READ):
            raise ValueError(f"malformed micro-op {m!r}")
        f, k, v = m
        if f == READ and v is not None:
            v = tuple(v)
        out.append((f, k, v))
    return tuple(out)


@dataclass
class Txn:
    """One transaction instance recovered from the history."""

    index: int                 # node id in the graph
    op: Op                     # the completion (or lone invoke) op
    invoke_at: int             # history position of the invocation
    complete_at: int           # history position of the completion
    status: str                # "ok" | "fail" | "info"
    mops: Tuple[Tuple[Any, ...], ...] = ()
    dirty: bool = False        # failed txn whose writes were observed


@dataclass
class TxnGraph:
    """The inferred dependency graph plus everything the counterexample
    decoder needs to speak in terms of actual ops."""

    txns: List[Txn]
    adj: np.ndarray                      # (4, n, n) bool — PLANES order
    labels: Dict[Tuple[int, int], List[Tuple[str, Any]]]
    anomalies: List[dict] = field(default_factory=list)
    orders: Dict[Any, Tuple[Any, ...]] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.txns)

    def padded(self, n_pad: Optional[int] = None) -> np.ndarray:
        """The adjacency tensor padded to a pow2 txn count (floor
        ``TXN_N_FLOOR``) — pad rows/cols carry no edges, so they are
        inert under closure."""
        n = self.n
        np2 = n_pad if n_pad is not None else next_pow2(max(n, 1),
                                                        TXN_N_FLOOR)
        if np2 < n:
            raise ValueError(f"n_pad {np2} < {n} txns")
        out = np.zeros((len(PLANES), np2, np2), dtype=bool)
        out[:, :n, :n] = self.adj
        return out


def txns_of_history(history: Sequence[Op]) -> Tuple[List[Txn], List[dict]]:
    """Pair txn invocations with their completions. A process runs one
    txn at a time (the harness worker contract); an unpaired invoke or
    an :info completion is indeterminate — its writes may be visible.
    Non-txn ops (nemesis, other workloads) are skipped."""
    txns: List[Txn] = []
    anomalies: List[dict] = []
    open_at: Dict[Any, Tuple[int, Op]] = {}
    for i, op in enumerate(history):
        if op.f != "txn":
            continue
        if op.type == "invoke":
            if op.process in open_at:
                raise ValueError(
                    f"process {op.process!r} double-pending at {i}")
            open_at[op.process] = (i, op)
            continue
        # an orphan completion (truncated history) has an UNKNOWN
        # invoke time: -1 keeps it unconstrained in the realtime
        # plane instead of fabricating rt edges from its completion
        # position (lost invokes may have overlapped anything)
        inv_i, inv_op = open_at.pop(op.process, (-1, op))
        try:
            mops = micro_ops(op.value if op.value is not None
                             else inv_op.value)
        except ValueError as e:
            anomalies.append({"name": "malformed", "op": op,
                              "error": str(e)})
            continue
        txns.append(Txn(index=len(txns), op=op, invoke_at=inv_i,
                        complete_at=i, status=op.type, mops=mops))
    for inv_i, inv_op in open_at.values():
        try:
            mops = micro_ops(inv_op.value)
        except ValueError as e:
            anomalies.append({"name": "malformed", "op": inv_op,
                              "error": str(e)})
            continue
        txns.append(Txn(index=len(txns), op=inv_op, invoke_at=inv_i,
                        complete_at=len(history), status="info",
                        mops=mops))
    return txns, anomalies


def _version_orders(txns: List[Txn], anomalies: List[dict]):
    """Longest-read version order per key + the value->writer map.
    Reads must agree prefix-wise; disagreement is flagged once per
    key. Duplicate values (in one read, or appended twice) are the
    ``-D`` shape."""
    writer: Dict[Tuple[Any, Any], int] = {}
    longest: Dict[Any, Tuple[Any, ...]] = {}
    for t in txns:
        for f, k, v in t.mops:
            if f != APPEND or v is None:
                # a value-less append (an invocation that never
                # learned its value, e.g. an aborted generator txn)
                # can't be tracked
                continue
            if (k, v) in writer:
                anomalies.append({
                    "name": "duplicate",
                    "key": k, "value": v,
                    "txns": [writer[(k, v)], t.index],
                    "note": "value appended by two txns (no-dedup)"})
            else:
                writer[(k, v)] = t.index
    for t in txns:
        if t.status != "ok":
            continue
        for f, k, v in t.mops:
            if f != READ or v is None:
                continue
            if len(set(v)) != len(v):
                anomalies.append({
                    "name": "duplicate", "key": k, "txn": t.index,
                    "read": v,
                    "note": "value read twice in one list"})
            phantom = [x for x in v if (k, x) not in writer]
            if phantom:
                # a value NOBODY appended is fabricated/corrupted
                # data — exactly the dirty-data class this checker
                # hunts; silently accepting it would also suppress
                # the wr/ww edges of the legitimate neighbors
                anomalies.append({
                    "name": "unexpected-value", "key": k,
                    "txn": t.index, "values": phantom,
                    "note": "read observed value(s) no txn appended"})
            cur = longest.get(k, ())
            short, long_ = sorted((cur, tuple(v)), key=len)
            if long_[:len(short)] != short:
                anomalies.append({
                    "name": "incompatible-order", "key": k,
                    "txn": t.index, "read": v, "longest": cur})
                continue
            longest[k] = long_
    return longest, writer


def infer_edges(history: Sequence[Op],
                realtime: bool = False) -> TxnGraph:
    """Run the whole host pass: txn recovery, version orders, direct
    anomalies, and the (4, n, n) dependency adjacency."""
    txns, anomalies = txns_of_history(history)
    orders, writer = _version_orders(txns, anomalies)

    # failed/indeterminate txns join the graph only when their writes
    # are OBSERVED (their effects provably happened). A failed txn
    # observed is the G1a aborted read; an :info txn observed is a
    # normal maybe-committed outcome.
    observed: set = set()
    for k, order in orders.items():
        for v in order:
            w = writer.get((k, v))
            if w is not None:
                observed.add(w)
    node_of: Dict[int, int] = {}
    nodes: List[Txn] = []
    for t in txns:
        if t.status == "ok" or t.index in observed:
            if t.status != "ok":
                t.dirty = True
            node_of[t.index] = len(nodes)
            nodes.append(t)
    for t in nodes:
        if t.dirty and t.status == "fail":
            anomalies.append({
                "name": "G1a", "txn": node_of[t.index],
                "note": "a :fail txn's append was observed by a "
                        "committed read (aborted read / dirty "
                        "commit)"})

    n = len(nodes)
    adj = np.zeros((len(PLANES), n, n), dtype=bool)
    labels: Dict[Tuple[int, int], List[Tuple[str, Any]]] = {}

    def edge(plane: str, a: int, b: int, key: Any) -> None:
        if a == b:
            return
        p = PLANES.index(plane)
        if not adj[p, a, b]:
            adj[p, a, b] = True
        labels.setdefault((a, b), []).append((plane, key))

    pos: Dict[Tuple[Any, Any], int] = {}
    for k, order in orders.items():
        for i, v in enumerate(order):
            pos[(k, v)] = i
        # ww: consecutive observed appends
        for a, b in zip(order, order[1:]):
            wa, wb = writer.get((k, a)), writer.get((k, b))
            if wa in node_of and wb in node_of:
                edge("ww", node_of[wa], node_of[wb], k)

    for t in nodes:
        ti = node_of[t.index]
        for f, k, v in t.mops:
            if f != READ or v is None:
                continue
            # strip this txn's OWN trailing appends (a read after an
            # append inside one txn sees it; it is not a dependency)
            seen = list(v)
            while seen and writer.get((k, seen[-1])) == t.index:
                seen.pop()
            order = orders.get(k, ())
            if seen:
                last = seen[-1]
                w = writer.get((k, last))
                if w is not None and w in node_of:
                    edge("wr", node_of[w], ti, k)
                nxt = pos.get((k, last))
                nxt = None if nxt is None else nxt + 1
            else:
                nxt = 0
            if nxt is not None and nxt < len(order):
                w = writer.get((k, order[nxt]))
                if w is not None and w in node_of:
                    edge("rw", ti, node_of[w], k)

    if realtime and n:
        # one broadcast, not an O(n^2) Python loop: the service runs
        # this at admission on a single CPU, where a 4096-txn double
        # loop would stall the whole daemon for over a minute. rt
        # edges carry no per-edge labels either (~n^2/2 of them at
        # realtime) — the counterexample decoder synthesizes the
        # constant ("rt", None) label on demand.
        ok = np.array([t.status == "ok" for t in nodes])
        comp = np.array([t.complete_at for t in nodes])
        inv = np.array([t.invoke_at for t in nodes])
        rt = (comp[:, None] < inv[None, :]) & ok[:, None] & ok[None, :]
        np.fill_diagonal(rt, False)
        adj[PLANES.index("rt")] = rt

    return TxnGraph(txns=nodes, adj=adj, labels=labels,
                    anomalies=anomalies, orders=orders)


__all__ = ["TXN_N_FLOOR", "PLANES", "Txn", "TxnGraph", "micro_ops",
           "txns_of_history", "infer_edges"]
