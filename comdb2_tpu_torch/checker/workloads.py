"""Workload-specific checkers from the comdb2 test suite and Adya.

- :class:`BankChecker` — total-balance invariant over reads
  (``comdb2/core.clj:152-177``)
- :class:`DirtyReadsChecker` — a failed write's value must never become
  visible to a read (``comdb2/core.clj:492-523``)
- :class:`G2Checker` — Adya G2 anti-dependency cycles: at most one
  insert may succeed per key (``jepsen/adya.clj:57-83``)
"""

from __future__ import annotations

from typing import Any, Dict

from .checkers import UNKNOWN, Checker
from ..ops.kv import is_tuple


def freeze_value(x: Any) -> Any:
    """Coerce a (possibly nested) op value to a hashable form: lists
    and tuples become tuples, sets frozensets, dicts sorted pair
    tuples. Mirrors ``ops.history._plain`` for values that did NOT
    arrive through the EDN reader — a client handing the checker raw
    lists must not crash the set membership test."""
    if isinstance(x, (list, tuple)):
        return tuple(freeze_value(e) for e in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(freeze_value(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted(((freeze_value(k), freeze_value(v))
                             for k, v in x.items()), key=repr))
    return x


class BankChecker(Checker):
    """Balances must all be present and sum to the model's total. The
    model here is a plain dict ``{"n": accounts, "total": sum}``
    (``comdb2/core.clj:152-177``)."""

    def check(self, test, model, history, opts=None):
        n = model["n"]
        total = model["total"]
        bad_reads = []
        for op in history:
            if op.type != "ok" or op.f != "read" or op.value is None:
                continue
            balances = list(op.value)
            if len(balances) != n:
                bad_reads.append({"type": "wrong-n", "expected": n,
                                  "found": len(balances), "op": op})
            elif sum(balances) != total:
                bad_reads.append({"type": "wrong-total", "expected": total,
                                  "found": sum(balances), "op": op})
        return {"valid?": not bad_reads, "bad-reads": bad_reads}


bank_checker = BankChecker()


class DirtyReadsChecker(Checker):
    """Looks for a failed write's value visible to some read; also
    reports reads whose per-node values disagree
    (``comdb2/core.clj:492-523``: read values are sequences of the row
    as seen from each node).

    This is the parity oracle for the device ``wl-dirty`` family
    (:mod:`.wl`), so it must be exact: values are
    frozen to hashable tuples before set membership (a raw-list
    payload used to raise ``TypeError`` out of the set build), and a
    read whose value is a scalar or a ``str`` — which would silently
    iterate per CHARACTER — is rejected with a ``malformed-reads``
    cause instead of producing a wrong verdict."""

    def check(self, test, model, history, opts=None):
        failed_writes = {freeze_value(op.value) for op in history
                         if op.type == "fail" and op.f == "write"}
        reads = []
        malformed = []
        for i, op in enumerate(history):
            if op.type != "ok" or op.f != "read" or op.value is None:
                continue
            if isinstance(op.value, (str, bytes)) \
                    or not isinstance(op.value, (list, tuple)):
                malformed.append(i if op.index is None else op.index)
                continue
            reads.append(tuple(freeze_value(x) for x in op.value))
        inconsistent = [v for v in reads if len(set(v)) > 1]
        filthy = [v for v in reads
                  if any(x in failed_writes for x in v)]
        out = {"valid?": not filthy,
               "inconsistent-reads": inconsistent,
               "dirty-reads": filthy}
        if malformed:
            out["valid?"] = UNKNOWN
            out["malformed-reads"] = malformed
        return out


dirty_reads_checker = DirtyReadsChecker()


class G2Checker(Checker):
    """At most one :insert completes successfully for any given key.
    Op values are ``(key, [a-id, b-id])`` tuples from the independent
    generator (``adya.clj:57-83``)."""

    def check(self, test, model, history, opts=None):
        counts: Dict[Any, int] = {}
        for op in history:
            if op.f != "insert" or op.value is None:
                continue
            v = op.value
            k = v.key if is_tuple(v) else v[0]
            counts.setdefault(k, 0)
            if op.type == "ok":
                counts[k] += 1
        insert_count = sum(1 for c in counts.values() if c > 0)
        illegal = {k: c for k, c in sorted(counts.items(), key=repr)
                   if c > 1}
        return {"valid?": not illegal,
                "key-count": len(counts),
                "legal-count": insert_count - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


g2_checker = G2Checker()


# --- dependency-graph second opinions ---------------------------------------
#
# The bespoke checkers above each pattern-match ONE anomaly shape;
# the txn dependency-graph checker (:mod:`..txn`) re-derives the
# same verdicts from first principles (ww/wr/rw cycles, G1a). The
# composed forms run both and merge by verdict priority — on the
# seeded negative-control histories the two must agree, which is
# exactly what tests/test_txn_cluster.py asserts.

def _graph_second_opinion(adapter_name: str):
    from ..txn import adapters
    from .checkers import Serializable

    return Serializable(backend="host",
                        adapter=getattr(adapters, adapter_name))


def g2_composed():
    """Adya count shortcut + dependency-graph view of the same run."""
    from .checkers import compose

    return compose({"adya": g2_checker,
                    "graph": _graph_second_opinion("g2_as_txns")})


def dirty_reads_composed():
    """Visible-failed-write scan + graph G1a view of the same run."""
    from .checkers import compose

    return compose({"dirty": dirty_reads_checker,
                    "graph": _graph_second_opinion(
                        "dirty_reads_as_txns")})
