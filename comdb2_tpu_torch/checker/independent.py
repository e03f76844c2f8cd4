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

When the test or ``opts`` names a store directory, each key's
``results.edn`` and ``history.edn`` go under ``independent/<k>/``, and
the base checker writes its own artifacts there (``linear.svg`` for an
INVALID key), as in the JAX package. ``mesh=`` (a tuple of devices,
``service.sharding.make_mesh``) splits that launch over the mesh's
devices through ``check_batch``'s mesh routes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List

from ..harness.store import _edn_safe, artifact_dir
from ..models.memo import MemoOverflow
from ..ops.edn import write_edn
from ..ops.history import history_to_edn
from ..ops.kv import KVTuple, is_tuple, tuple_, wrap_keyed_history
from ..ops.op import Op
from .checkers import Checker, Linearizable, check_safe, merge_valid


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
        ks = history_keys(history)
        subs = subhistories(ks, history)
        # per-key artifact routing: a failing base checker writes its
        # counterexample under independent/<k>/ (the reference's per-key
        # store layout) instead of every key clobbering one linear.svg
        base_dir = artifact_dir(test, opts)

        def key_opts(k):
            if base_dir is None:
                return opts
            return {**(opts or {}),
                    "dir": os.path.join(base_dir, "independent", str(k))}

        # honor an explicit host backend: no device batch for it
        device_ok = not (isinstance(self.base, Linearizable)
                         and getattr(self.base, "backend", None) == "host")
        if isinstance(self.base, Linearizable) and len(ks) > 1 \
                and device_ok:
            results = self._check_linearizable_batch(model, subs,
                                                     key_opts)
        else:
            results = {k: check_safe(self.base, test, model, subs[k],
                                     key_opts(k))
                       for k in ks}
        self._write_artifacts(base_dir, subs, results)
        # false > unknown > true, like compose; only definitively-invalid
        # keys are failures (the reference treats :unknown as truthy,
        # independent.clj:288-295)
        valid = merge_valid([r.get("valid?") for r in results.values()])
        failures = [k for k, r in results.items()
                    if r.get("valid?") is False]
        return {"valid?": valid, "results": results, "failures": failures}

    @staticmethod
    def _write_artifacts(base, subs, results) -> None:
        """Persist per-key results.edn + history.edn under
        ``independent/<k>/`` in the store dir ``base`` when there is one
        (``independent.clj:272-283``); best-effort host code, as in the
        JAX package: an unserializable payload must not turn a computed
        verdict into an error."""
        if base is None:
            return
        try:
            for k, r in results.items():
                d = os.path.join(base, "independent", str(k))
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "results.edn"), "w") as fh:
                    fh.write(write_edn(_edn_safe(r)))
                with open(os.path.join(d, "history.edn"), "w") as fh:
                    fh.write(history_to_edn(subs[k]))
        except Exception:
            pass

    def _check_linearizable_batch(self, model, subs: Dict[Any, List[Op]],
                                  key_opts) -> Dict[Any, dict]:
        """One device launch for all keys; unknowns (frontier overflow),
        invalid keys and batches the port cannot take re-check each key
        alone through the escalating path."""
        from ..ops.packed import pack_history
        from . import batch as B
        from . import linear_torch as LT

        ks = list(subs)

        def each_alone():
            return {k: check_safe(self.base, {}, model, subs[k],
                                  key_opts(k))
                    for k in ks}

        # The JAX package catches every exception around packing and the
        # device check alike and re-checks each key alone. Here only what
        # a HISTORY can raise falls back: on the host, a malformed
        # history (RuntimeError / KeyError from ``pack_history``'s
        # completion pass, ValueError) and a state space past the memo's
        # cap (MemoOverflow). Every error of ``check_batch`` — a kernel
        # that does not build or launch, CUDA itself — propagates, so a
        # device fault can never pass as a verdict. ``mesh`` rides
        # ``check_batch``'s mesh routes.
        try:
            packeds = [pack_history(list(subs[k])) for k in ks]
            pb = B.pack_batch(packeds, model)
        except (RuntimeError, KeyError, ValueError, MemoOverflow):
            return each_alone()
        status, _, _ = B.check_batch(pb, F=self.batch_frontier,
                                     mesh=self.mesh,
                                     device=self.base.device)
        results: Dict[Any, dict] = {}
        for i, k in enumerate(ks):
            if int(status[i]) == LT.VALID:
                results[k] = {"valid?": True, "backend": "device-batch"}
            else:
                # invalid or overflow: re-check solo for an exact verdict
                # with escalation and a decoded counterexample
                results[k] = check_safe(self.base, {}, model, subs[k],
                                        key_opts(k))
        return results


def checker(base: Checker, **kw) -> IndependentChecker:
    return IndependentChecker(base, **kw)


__all__ = ["IndependentChecker", "KVTuple", "checker", "history_keys",
           "is_tuple", "subhistories", "subhistory", "tuple_",
           "wrap_keyed_history"]
