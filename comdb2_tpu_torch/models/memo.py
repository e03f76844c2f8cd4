"""State-space memoization — what lets model stepping run on a device.

Mirrors the semantics of the reference's ``knossos/model/memo.clj``:
enumerate the *entire reachable state space* of a model under a history's
distinct transitions by fixed-point closure (``memo.clj:93-97``), number
states and transitions, and replace ``step`` with a table lookup:
``succ[state_id, transition_id] -> state_id' | -1`` (inconsistent).

On the device one model step is then a single gather from that table
(``memo.clj:99-126`` does the same with two java arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from .model import Model, step
from ..ops.packed import PackedHistory


class MemoOverflow(Exception):
    """Reachable state space exceeded the cap; callers report
    :unknown."""


@dataclass
class MemoizedModel:
    """A model compiled to integer tables.

    ``succ[s, t]`` is the state reached by applying transition ``t`` in
    state ``s``, or -1 if inconsistent. ``states[i]`` is the original
    model object for state id ``i`` (id 0 = initial). ``transitions[t]``
    is the ``(f, value)`` pair for transition id ``t``.
    """

    states: List[Model]
    transitions: List[Tuple[Any, Any]]
    succ: np.ndarray  # int32[S, T]

    @property
    def n_states(self) -> int:
        return len(self.states)

    @property
    def n_transitions(self) -> int:
        return len(self.transitions)

    def step_id(self, state_id: int, trans_id: int) -> int:
        return int(self.succ[state_id, trans_id])


def transitions_of(packed: PackedHistory) -> List[Tuple[Any, Any]]:
    """Distinct (f, value) transitions of a packed history, in transition-id
    order (``memo.clj:66-73``)."""
    out = []
    for f_id, v_id in packed.transition_table:
        out.append((packed.f_table[f_id], packed.value_table[v_id]))
    return out


def memoize_model(model: Model,
                  transitions: List[Tuple[Any, Any]],
                  max_states: int = 1 << 20,
                  max_depth: Optional[int] = None) -> MemoizedModel:
    """Fixed-point closure of ``model`` under ``transitions``.

    BFS from the initial model; every reachable state gets an id; the
    successor table is materialized densely (``memo.clj:156-170`` builds
    the same graph as linked wrapper objects).

    ``max_depth`` bounds the BFS depth. With ``max_depth`` = the number
    of invocations in the history this is *exact*, not an approximation:
    a checking run linearizes each invocation at most once, so states
    whose shortest path from the initial state exceeds the invocation
    count can never be stepped into. (States *at* the depth bound get
    all-inconsistent successor rows; reaching one consumes every
    invocation, so such a config has no pending calls left to step.)
    This keeps unbounded-growth models — queues, sets — finite where the
    reference's unbounded closure (``memo.clj:93-97``) would diverge.
    """
    ids = {model: 0}
    states: List[Model] = [model]
    rows: List[List[int]] = []
    frontier = [model]
    T = len(transitions)
    depth = 0
    while frontier:
        if max_depth is not None and depth >= max_depth:
            # terminal depth: never stepped (see docstring); -1 rows
            rows.extend([[-1] * T] * len(frontier))
            break
        next_frontier = []
        for m in frontier:
            row = []
            for (f, value) in transitions:
                m2 = step(m, f, value)
                if m2 is None:
                    row.append(-1)
                    continue
                sid = ids.get(m2)
                if sid is None:
                    sid = len(states)
                    if sid >= max_states:
                        raise MemoOverflow(
                            f"reachable state space exceeds {max_states}")
                    ids[m2] = sid
                    states.append(m2)
                    next_frontier.append(m2)
                row.append(sid)
            rows.append(row)
        frontier = next_frontier
        depth += 1
    succ = np.asarray(rows, np.int32).reshape(len(states), T)
    return MemoizedModel(states=states, transitions=transitions, succ=succ)


def memo(model: Model, packed: PackedHistory,
         max_states: int = 1 << 20) -> MemoizedModel:
    """Memoize ``model`` over the distinct transitions of ``packed``
    (the reference's entry point, ``memo.clj:182-196``), with the BFS
    depth bounded by the history's invocation count."""
    from ..ops.op import INVOKE

    n_invokes = int(((packed.type == INVOKE) & ~packed.fails).sum())
    return memoize_model(model, transitions_of(packed), max_states,
                         max_depth=n_invokes)
