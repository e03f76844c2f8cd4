"""Second-opinion views: legacy workload histories as txn histories.

The bespoke :class:`~comdb2_tpu_torch.checker.workloads.G2Checker` and
:class:`~comdb2_tpu_torch.checker.workloads.DirtyReadsChecker` each encode
ONE anomaly shape. Re-expressing their histories as txn micro-ops
lets the dependency-graph checker pass judgement on the same runs —
two independent verdicts that must agree on the seeded negative
controls (the cross-wiring satellite). The adapters are lossy only
where the source history is:

- G2 ops never record what their predicate reads observed, but a
  committed insert PROVES its predicate saw empty (that is the only
  path to the insert), and insert-only tables mean the final table
  contents are exactly the committed inserts — so a synthesized
  final audit read anchors the version order the rw edges need.
- Dirty-reads registers are overwriting (no recoverable version
  order), so each write becomes its own single-append key: a read
  observing value x is a read of x's key, which makes "a :fail
  write's value was read" exactly the graph checker's G1a.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops.kv import is_tuple
from ..ops.op import Op


def g2_as_txns(history: Sequence[Op]) -> List[Op]:
    """Adya-G2 insert ops -> txn ops. Each insert is one txn that
    predicate-read BOTH tables for its key (observed empty) and
    appended its row id to its own table's list; a final audit txn
    reads every touched table list (committed inserts, history
    order). Two committed inserts per key then form the rw/rw cycle
    whose count shortcut is G2Checker."""
    out: List[Op] = []
    committed: dict = {}                  # (k, tbl) -> [rid...]
    keys: List = []
    for op in history:
        if op.f != "insert" or op.value is None:
            continue
        v = op.value
        k, ids = (v.key, v.value) if is_tuple(v) else (v[0], v[1])
        a_id, b_id = ids
        tbl, rid = ("a", a_id) if a_id is not None else ("b", b_id)
        empty = None if op.type == "invoke" else ()
        mops = (("r", (k, "a"), empty), ("r", (k, "b"), empty),
                ("append", (k, tbl), rid))
        out.append(op.with_(f="txn", value=mops))
        if (k, "a") not in committed:
            keys.append(k)
            committed[(k, "a")] = []
            committed[(k, "b")] = []
        if op.type == "ok":
            committed[(k, tbl)].append(rid)
    if out:
        audit = tuple(("r", kt, tuple(rids))
                      for kt, rids in committed.items())
        out.append(Op("g2-audit", "invoke", "txn",
                      tuple((f, kt, None) for f, kt, _ in audit)))
        out.append(Op("g2-audit", "ok", "txn", audit))
    return out


def dirty_reads_as_txns(history: Sequence[Op]) -> List[Op]:
    """Dirty-reads ops -> txn ops, one single-append key per written
    value: ``write x`` appends x to key ``("dirty", x)``; a read
    observing x reads that key as ``(x,)``. A value written more than
    once is skipped (attribution ambiguous — the adapter declines
    rather than fabricate evidence); the seeded control tests write
    distinct values. A read of a :fail write's value then surfaces as
    the graph checker's G1a."""
    writes: dict = {}                     # x -> write count
    for op in history:
        if op.f == "write" and op.type != "invoke" \
                and op.value is not None:
            writes[op.value] = writes.get(op.value, 0) + 1
    out: List[Op] = []
    for op in history:
        if op.f == "write" and op.value is not None:
            if writes.get(op.value, 0) != 1:
                continue
            out.append(op.with_(
                f="txn", value=(("append", ("dirty", op.value),
                                 op.value),)))
        elif op.f == "read" and op.value is not None:
            observed = tuple(x for x in set(op.value)
                             if writes.get(x, 0) == 1)
            mops = tuple(("r", ("dirty", x),
                          None if op.type == "invoke" else (x,))
                         for x in observed)
            if mops:
                out.append(op.with_(f="txn", value=mops))
    return out


__all__ = ["g2_as_txns", "dirty_reads_as_txns"]
