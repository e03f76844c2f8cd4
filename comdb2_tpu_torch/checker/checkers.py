"""The checker layer.

A checker validates a complete history against a model and returns a map
with at least ``"valid?"`` — ``True``, ``False``, or ``"unknown"``.
Mirrors the reference's ``jepsen/checker.clj``:

- :func:`check_safe` wraps exceptions as ``:unknown`` (``checker.clj:54-64``)
- :func:`compose` runs named sub-checkers in parallel and merges their
  verdicts by priority false > unknown > true (``checker.clj:20-35,274-286``)
- :class:`Linearizable` drives the device frontier search
  (``checker.clj:71-85``)
- :class:`Serializable` drives the txn dependency-graph checker
- :class:`SetChecker` — ok/lost/unexpected/recovered (``checker.clj:108-154``)
- :class:`Queue` / :class:`TotalQueue` — (``checker.clj:87-218``)
- :class:`Counter` — bounds-interval analysis (``checker.clj:220-272``)

The counterpart of the JAX package's ``checker/checkers.py``, with the
same verdict maps. ``Linearizable`` and ``Serializable`` take
``device=`` (``None`` means ``cuda``). Not ported yet: the store
artifacts the JAX package writes on a failure when the test names a
store directory (``linear.svg``, ``serializable.txt`` /
``serializable.svg``); they wait for the harness and report slice, and
never change a verdict map.
"""

from __future__ import annotations

import traceback
from collections import Counter as Multiset
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from ..models import model as M
from ..ops.op import Op
from ..utils.intervals import fraction, integer_interval_set_str
from . import linear

UNKNOWN = "unknown"

# :valid? priorities — larger dominates under composition
# (checker.clj:20-25)
_VALID_PRIORITY = {True: 0, UNKNOWN: 0.5, False: 1}


def merge_valid(valids: Sequence[Any]):
    """The highest-priority verdict wins (``checker.clj:27-35``).
    A verdict value outside the tri-state (a buggy sub-checker
    returning ``"crashed"``, a None) coerces to ``unknown`` — it must
    neither silently win as a pseudo-False nor leak a non-tri-state
    value to callers switching on the result."""
    out = True
    for v in valids:
        if v not in _VALID_PRIORITY:
            v = UNKNOWN
        if _VALID_PRIORITY[v] > _VALID_PRIORITY[out]:
            out = v
    return out


class Checker:
    """Protocol: ``check(test, model, history, opts) -> dict`` with a
    ``"valid?"`` key (``checker.clj:37-52``)."""

    def check(self, test: dict, model, history: List[Op],
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError


def check_safe(checker: Checker, test: dict, model, history: List[Op],
               opts: Optional[dict] = None) -> dict:
    """Run a checker, converting exceptions to an ``unknown`` verdict
    with the traceback attached (``checker.clj:54-64``)."""
    try:
        return checker.check(test, model, history, opts)
    except Exception:
        return {"valid?": UNKNOWN, "error": traceback.format_exc()}


class UnbridledOptimism(Checker):
    """Everything is awesome (``checker.clj:66-69``)."""

    def check(self, test, model, history, opts=None):
        return {"valid?": True}


unbridled_optimism = UnbridledOptimism()


class Compose(Checker):
    """Run a map of named checkers concurrently; result maps nest under
    their names, ``"valid?"`` merges by priority (``checker.clj:274-286``).
    """

    def __init__(self, checker_map: Dict[str, Checker]):
        self.checker_map = dict(checker_map)

    def check(self, test, model, history, opts=None):
        names = list(self.checker_map)
        with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
            futs = {name: pool.submit(check_safe, self.checker_map[name],
                                      test, model, history, opts)
                    for name in names}
            results = {name: f.result() for name, f in futs.items()}
        out: dict = dict(results)
        out["valid?"] = merge_valid([r.get("valid?") for r in results.values()])
        return out


def compose(checker_map: Dict[str, Checker]) -> Compose:
    return Compose(checker_map)


class Linearizable(Checker):
    """Validates linearizability with the memoized frontier search
    (``checker.clj:71-85`` → ``knossos.linear/analysis``). Frontier
    samples in the result are truncated to 10, as the reference truncates
    configs/final-paths."""

    def __init__(self, backend: str = "auto", device=None,
                 **analysis_kw):
        self.backend = backend
        self.device = device
        self.analysis_kw = analysis_kw

    def check(self, test, model, history, opts=None):
        a = linear.analysis(model, history, backend=self.backend,
                            device=self.device, **self.analysis_kw)
        out = a.to_map()
        if "configs" in out:
            out["configs"] = out["configs"][:10]
        if out.get("paths"):
            out["paths"] = out["paths"][:10]
        return out


linearizable = Linearizable()


class Serializable(Checker):
    """Transactional serializability via the dependency-graph checker
    (:mod:`comdb2_tpu_torch.txn`): Elle-style edge inference over
    list-append txn ops, then cycle detection — host Tarjan or the
    matrix-closure engine on the card (one device call per history).

    ``adapter`` optionally re-expresses a legacy workload history as
    txn ops first (see :mod:`comdb2_tpu_torch.txn.adapters`) so the graph
    checker can second-opinion the bespoke checkers. An adapter
    returning an empty list yields ``unknown`` (nothing to check is
    not a clean bill)."""

    def __init__(self, backend: str = "auto", realtime: bool = False,
                 adapter=None, device=None):
        self.backend = backend
        self.realtime = realtime
        self.adapter = adapter
        self.device = device

    def check(self, test, model, history, opts=None):
        from ..txn import check_txn

        ops = list(history)
        if self.adapter is not None:
            ops = self.adapter(ops)
            if not ops:
                return {"valid?": UNKNOWN,
                        "error": "adapter produced no txn ops"}
        return check_txn(ops, backend=self.backend,
                         realtime=self.realtime, device=self.device)


serializable = Serializable()


class Queue(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only ok dequeues happened, then fold the model
    over that subsequence. O(n) — use with an unordered-queue model
    (``checker.clj:87-105``)."""

    def check(self, test, model, history, opts=None):
        cur = model
        for op in history:
            take = (op.type == "invoke" if op.f == "enqueue"
                    else op.type == "ok" if op.f == "dequeue" else False)
            if not take:
                continue
            cur = M.step(cur, op.f, op.value)
            if cur is None:
                return {"valid?": False,
                        "error": f"inconsistent at {op}"}
        return {"valid?": True, "final-queue": cur}


queue = Queue()


class SetChecker(Checker):
    """Adds followed by a final read: every successful add must be read
    back; nothing never-attempted may appear (``checker.clj:108-154``).
    """

    def check(self, test, model, history, opts=None):
        attempts = {op.value for op in history
                    if op.type == "invoke" and op.f == "add"}
        adds = {op.value for op in history
                if op.type == "ok" and op.f == "add"}
        final_read = None
        for op in history:
            if op.type == "ok" and op.f == "read":
                final_read = op.value
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "Set was never read"}
        final_read = set(final_read)
        ok = final_read & attempts
        unexpected = final_read - attempts
        lost = adds - final_read
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
            "ok-frac": fraction(len(ok), len(attempts)),
            "unexpected-frac": fraction(len(unexpected), len(attempts)),
            "lost-frac": fraction(len(lost), len(attempts)),
            "recovered-frac": fraction(len(recovered), len(attempts)),
        }


set_checker = SetChecker()


class TotalQueue(Checker):
    """What goes in must come out — multiset analysis over
    enqueues/dequeues; requires the history to drain the queue
    (``checker.clj:163-218``)."""

    def check(self, test, model, history, opts=None):
        attempts = Multiset(op.value for op in history
                            if op.type == "invoke" and op.f == "enqueue")
        enqueues = Multiset(op.value for op in history
                            if op.type == "ok" and op.f == "enqueue")
        dequeues = Multiset(op.value for op in history
                            if op.type == "ok" and op.f == "dequeue")
        ok = dequeues & attempts
        unexpected = Multiset({v: n for v, n in dequeues.items()
                               if v not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        n_att = sum(attempts.values())
        return {
            "valid?": not lost and not unexpected,
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
            "ok-frac": fraction(sum(ok.values()), n_att),
            "unexpected-frac": fraction(sum(unexpected.values()), n_att),
            "duplicated-frac": fraction(sum(duplicated.values()), n_att),
            "lost-frac": fraction(sum(lost.values()), n_att),
            "recovered-frac": fraction(sum(recovered.values()), n_att),
        }


total_queue = TotalQueue()


class CounterChecker(Checker):
    """A monotonically-growing counter: each read must fall between the
    sum of ok adds at invoke time (lower) and the sum of attempted adds
    at completion time (upper) (``checker.clj:220-272``)."""

    def check(self, test, model, history, opts=None):
        lower = upper = 0
        pending: Dict[Any, list] = {}   # process -> [lower, read-value]
        reads: List[tuple] = []
        for op in history:
            key = (op.type, op.f)
            if key == ("invoke", "read"):
                pending[op.process] = [lower, op.value]
            elif key == ("ok", "read"):
                lo, _ = pending.pop(op.process)
                reads.append((lo, op.value, upper))
            elif key == ("invoke", "add"):
                upper += op.value
            elif key == ("ok", "add"):
                lower += op.value
        errors = [r for r in reads
                  if r[1] is None or not (r[0] <= r[1] <= r[2])]
        return {"valid?": not errors, "reads": reads, "errors": errors}


counter = CounterChecker()
