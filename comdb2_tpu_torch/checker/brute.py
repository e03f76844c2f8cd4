"""Exhaustive linearizability oracle for tiny histories.

The counterpart of the JAX package's ``checker/brute.py``. An
independent implementation (WGL-style: pick linearization orders
directly from call intervals) used only to cross-validate the real
checkers in tests. Mirrors the *definition* of linearizability the
reference's searches implement (``knossos/core.clj:82-145`` explores the
same space via world permutations) without sharing any code with them.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

from ..models.model import Model, step
from ..ops import history as hist
from ..ops.op import Op


class _Call:
    __slots__ = ("inv", "ret", "f", "value", "required")

    def __init__(self, inv, ret, f, value, required):
        self.inv, self.ret = inv, ret
        self.f, self.value = f, value
        self.required = required


def brute_valid(model: Model, history: List[Op]) -> bool:
    """True iff some linearization of the history's completed calls (with
    info calls optionally interleaved anywhere after their invocation) is
    legal under ``model``. History need not be completed/indexed."""
    h = hist.complete(history, index=True)
    calls: List[_Call] = []
    inflight = {}
    for op in h:
        if op.type == "invoke":
            inflight[op.process] = op
        elif op.type == "ok":
            inv = inflight.pop(op.process)
            calls.append(_Call(inv.index, op.index, inv.f, inv.value, True))
        elif op.type == "fail":
            inflight.pop(op.process, None)  # known failure: never happened
        elif op.type == "info":
            # completion unknown: may take effect at any point after invoke
            inv = inflight.pop(op.process, None)
            if inv is not None:
                calls.append(_Call(inv.index, math.inf, inv.f, inv.value,
                                   False))
    # processes still in flight at end of history are also indeterminate
    for inv in inflight.values():
        calls.append(_Call(inv.index, math.inf, inv.f, inv.value, False))

    n = len(calls)

    @lru_cache(maxsize=None)
    def dfs(remaining: frozenset, model_state) -> bool:
        req = [i for i in remaining if calls[i].required]
        if not req:
            return True
        for i in remaining:
            c = calls[i]
            # c may be linearized next iff no other unlinearized *required*
            # call returned before c was invoked
            if any(calls[j].ret < c.inv for j in req if j != i):
                continue
            m2 = step(model_state, c.f, c.value)
            if m2 is not None and dfs(remaining - {i}, m2):
                return True
        return False

    return dfs(frozenset(range(n)), model)
