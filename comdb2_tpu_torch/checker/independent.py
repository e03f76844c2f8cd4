"""Independent-key lifting — the batch axis of the framework.

The counterpart of the JAX package's ``checker/independent.py``;
mirrors ``jepsen/independent.clj``: a test of one register lifts to a
map of keys to registers by wrapping op values in ``(k, v)`` tuples,
partitioning the history per key, and checking each subhistory with a
base checker (``independent.clj:252-300``).

When the base checker is :class:`~.checkers.Linearizable`, all per-key
subhistories are packed against ONE shared memoized model and checked
in one device launch (:func:`~.batch.check_batch`, the segment-search
kernel's stream mode), on the base checker's device.

Not ported yet: the per-key store artifacts (``independent/<k>/``) the
JAX package writes when the test names a store directory — they wait
for the harness and report slice and change no verdict — and the
``mesh=`` route, which raises :class:`~.linear.EngineNotPorted`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

from ..models.memo import MemoOverflow
from ..ops.kv import KVTuple, is_tuple, tuple_, wrap_keyed_history
from ..ops.op import Op
from .checkers import Checker, Linearizable, check_safe, merge_valid
from .linear import EngineNotPorted


def history_keys(history: Iterable[Op]) -> List[Any]:
    """Distinct keys in first-appearance order
    (``independent.clj:227-238``)."""
    seen: Dict[Any, None] = {}
    for op in history:
        if is_tuple(op.value):
            seen.setdefault(op.value.key, None)
    return list(seen)


def subhistory(k, history: Iterable[Op]) -> List[Op]:
    """All ops without a differing key, tuples unwrapped — un-keyed ops
    (nemesis infos, logging) appear in every subhistory
    (``independent.clj:240-250``)."""
    out = []
    for op in history:
        v = op.value
        if not is_tuple(v):
            out.append(op)
        elif v.key == k:
            out.append(op.with_(value=v.value))
    return out


def subhistories(ks, history: Iterable[Op]) -> Dict[Any, List[Op]]:
    """Every key's :func:`subhistory` in one pass over the history (one
    scan per key would cost keys x ops)."""
    subs: Dict[Any, List[Op]] = {k: [] for k in ks}
    for op in history:
        v = op.value
        if not is_tuple(v):
            for sub in subs.values():
                sub.append(op)
        else:
            subs[v.key].append(op.with_(value=v.value))
    return subs


class IndependentChecker(Checker):
    """Lift a base checker over keyed histories: valid iff valid for
    every key's subhistory; per-key results under ``"results"``, invalid
    keys under ``"failures"`` (``independent.clj:252-300``)."""

    def __init__(self, base: Checker, batch_frontier: int = 256,
                 mesh=None):
        self.base = base
        self.batch_frontier = batch_frontier
        self.mesh = mesh

    def check(self, test, model, history, opts=None):
        if self.mesh is not None:
            raise EngineNotPorted("IndependentChecker: the mesh route is "
                                  "not ported yet")
        ks = history_keys(history)
        subs = subhistories(ks, history)
        # honor an explicit host backend: no device batch for it
        device_ok = not (isinstance(self.base, Linearizable)
                         and getattr(self.base, "backend", None) == "host")
        if isinstance(self.base, Linearizable) and len(ks) > 1 \
                and device_ok:
            results = self._check_linearizable_batch(model, subs, opts)
        else:
            results = {k: check_safe(self.base, test, model, subs[k], opts)
                       for k in ks}
        # false > unknown > true, like compose; only definitively-invalid
        # keys are failures (the reference treats :unknown as truthy,
        # independent.clj:288-295)
        valid = merge_valid([r.get("valid?") for r in results.values()])
        failures = [k for k, r in results.items()
                    if r.get("valid?") is False]
        return {"valid?": valid, "results": results, "failures": failures}

    def _check_linearizable_batch(self, model, subs: Dict[Any, List[Op]],
                                  opts=None) -> Dict[Any, dict]:
        """One device launch for all keys; unknowns (frontier overflow),
        invalid keys and batches the port cannot take re-check each key
        alone through the escalating path."""
        from ..ops.packed import pack_history
        from . import batch as B
        from . import linear_torch as LT

        ks = list(subs)

        def each_alone():
            return {k: check_safe(self.base, {}, model, subs[k], opts)
                    for k in ks}

        # The JAX package catches every exception around packing and the
        # device check alike and re-checks each key alone. Here only what
        # a HISTORY can raise falls back: on the host, a malformed
        # history (RuntimeError / KeyError from ``pack_history``'s
        # completion pass, ValueError) and a state space past the memo's
        # cap (MemoOverflow); from ``check_batch``, EngineNotPorted, a
        # shape the port's batch engines cannot take yet. Every other
        # error — a kernel that does not build or launch, CUDA itself —
        # propagates, so a device fault can never pass as a verdict.
        try:
            packeds = [pack_history(list(subs[k])) for k in ks]
            pb = B.pack_batch(packeds, model)
        except (RuntimeError, KeyError, ValueError, MemoOverflow):
            return each_alone()
        try:
            status, _, _ = B.check_batch(pb, F=self.batch_frontier,
                                         device=self.base.device)
        except EngineNotPorted:
            return each_alone()
        results: Dict[Any, dict] = {}
        for i, k in enumerate(ks):
            if int(status[i]) == LT.VALID:
                results[k] = {"valid?": True, "backend": "device-batch"}
            else:
                # invalid or overflow: re-check solo for an exact verdict
                # with escalation and a decoded counterexample
                results[k] = check_safe(self.base, {}, model, subs[k],
                                        opts)
        return results


def checker(base: Checker, **kw) -> IndependentChecker:
    return IndependentChecker(base, **kw)


__all__ = ["IndependentChecker", "KVTuple", "checker", "history_keys",
           "is_tuple", "subhistories", "subhistory", "tuple_",
           "wrap_keyed_history"]
