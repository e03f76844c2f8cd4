"""State-space memoization — what lets model stepping run on a device.

Mirrors the semantics of the reference's ``knossos/model/memo.clj``:
enumerate the *entire reachable state space* of a model under a history's
distinct transitions by fixed-point closure (``memo.clj:93-97``), number
states and transitions, and replace ``step`` with a table lookup:
``succ[state_id, transition_id] -> state_id' | -1`` (inconsistent).

On the device one model step is then a single gather from that table
(``memo.clj:99-126`` does the same with two java arrays).

:class:`IncrementalMemo` is the grow-only form streaming sessions use:
state ids stay stable as appends bring new transitions.
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


class IncrementalMemo:
    """Grow-only memoization for streaming sessions — state ids are
    STABLE across extensions, which is what lets a device-resident
    frontier carry survive ``append``s that introduce new transitions
    (:mod:`comdb2_tpu_torch.stream`): the carry stores state ids, so a
    re-numbering would invalidate every config on device.

    Semantics match :func:`memoize_model` run over the final
    (transitions, max_depth) pair: states are discovered at their
    MINIMAL distance from the initial state (a late-arriving
    transition that shortcuts an existing state relaxes its depth and
    re-expands it — without relaxation a state could stay terminal
    below the bound and wrongly reject a linearization), and states at
    depth >= ``max_depth`` keep all-inconsistent rows (the same
    exactness argument: reaching one consumes every invocation seen so
    far, so no config there has pending calls left to step). Only the
    state NUMBERING differs from a one-shot memoization (BFS discovery
    order vs extension order) — verdicts, fail indices and decoded
    counterexamples are id-independent.
    """

    def __init__(self, model: Model, max_states: int = 1 << 20):
        self.max_states = max_states
        self.states: List[Model] = [model]
        self.transitions: List[Tuple[Any, Any]] = []
        self._ids = {model: 0}
        self._depths = [0]
        #: per-state successor row (list of ids, len == len(transitions)
        #: when expanded) or None — unexpanded (terminal at the current
        #: depth bound, re-expandable when the bound grows)
        self._rows: List[Optional[List[int]]] = [None]
        self.max_depth = 0
        self._succ: Optional[np.ndarray] = None
        #: bumped whenever the table content changes — device-side
        #: copies (stream sessions) key their upload cache on it
        self.version = 0
        #: the extend-call log, replayed verbatim by checkpoint
        #: restore: state NUMBERING is extension-order-dependent and
        #: the device carries store state ids, so a restored memo must
        #: re-run the SAME extension sequence (a one-shot re-memoization
        #: would renumber and silently corrupt every resident config).
        #: O(distinct transitions), never O(history).
        self._log: List[Tuple[Tuple[Tuple[Any, Any], ...], int]] = []

    @property
    def n_states(self) -> int:
        return len(self.states)

    @property
    def n_transitions(self) -> int:
        return len(self.transitions)

    @property
    def succ(self) -> np.ndarray:
        """The dense successor table (unexpanded states: all -1).
        Cached until the next :meth:`extend`."""
        if self._succ is None:
            T = len(self.transitions)
            out = np.full((len(self.states), max(T, 1)), -1, np.int32)
            for i, row in enumerate(self._rows):
                if row is not None:
                    out[i, :len(row)] = row
            self._succ = out
        return self._succ

    def as_memoized(self) -> MemoizedModel:
        """A :class:`MemoizedModel` view (counterexample decode)."""
        return MemoizedModel(states=self.states,
                             transitions=self.transitions,
                             succ=self.succ)

    def _intern(self, m2: Model, depth: int, work) -> int:
        sid = self._ids.get(m2)
        if sid is None:
            sid = len(self.states)
            if sid >= self.max_states:
                raise MemoOverflow(
                    f"reachable state space exceeds {self.max_states}")
            self._ids[m2] = sid
            self.states.append(m2)
            self._depths.append(depth)
            self._rows.append(None)
            work.append(sid)
        elif depth < self._depths[sid]:
            # relaxation: a new shortcut lowered the state's minimal
            # distance. An unexpanded state may now sit below the
            # bound (expandable); an EXPANDED one must propagate the
            # lower depth through its successors — without the
            # cascade a state could stay terminal at the bound while
            # its true minimal distance is below it, and a
            # linearization stepping through it would be wrongly
            # rejected.
            self._depths[sid] = depth
            work.append(sid)
        return sid

    def checkpoint(self) -> dict:
        """Everything :meth:`restore` needs to rebuild this memo with
        IDENTICAL state numbering: the extend-call log (plus the cap).
        The states themselves are re-derived by replay — host data
        only, O(distinct transitions), never O(history)."""
        return {"max_states": self.max_states,
                "log": [(tuple(tr), d) for tr, d in self._log]}

    @classmethod
    def restore(cls, model: Model, ck: dict) -> "IncrementalMemo":
        """Replay the extend log onto a fresh memo — deterministic, so
        state ids (and therefore every id a device carry stores) come
        back bit-identical."""
        memo = cls(model, max_states=int(ck["max_states"]))
        for tr, d in ck["log"]:
            memo.extend([tuple(t) for t in tr], int(d))
        return memo

    def extend(self, transitions: List[Tuple[Any, Any]],
               max_depth: int) -> None:
        """Append ``transitions`` (ids continue the existing table) and
        raise the depth bound to ``max_depth``; close the reachable set
        under both. No-op when nothing changed."""
        from collections import deque

        T_old = len(self.transitions)
        if transitions:
            self.transitions = self.transitions + list(transitions)
        grew_depth = max_depth > self.max_depth
        self.max_depth = max(self.max_depth, max_depth)
        if not transitions and not grew_depth:
            return
        self._succ = None
        self.version += 1
        work: deque = deque()
        # new columns for every already-expanded state
        if transitions:
            for sid in range(len(self._rows)):
                row = self._rows[sid]
                if row is None:
                    continue
                m = self.states[sid]
                d = self._depths[sid]
                for (f, value) in self.transitions[T_old:]:
                    m2 = step(m, f, value)
                    row.append(-1 if m2 is None
                               else self._intern(m2, d + 1, work))
        # unexpanded states below the (possibly raised) bound
        for sid, row in enumerate(self._rows):
            if row is None and self._depths[sid] < self.max_depth:
                work.append(sid)
        while work:
            sid = work.popleft()
            d = self._depths[sid]
            row = self._rows[sid]
            if row is not None:
                # relaxation cascade: re-offer the (already computed)
                # successors at the lowered depth; terminates because
                # depths only decrease and are bounded by 0
                for s2 in row:
                    if s2 >= 0 and self._depths[s2] > d + 1:
                        self._depths[s2] = d + 1
                        work.append(s2)
                continue
            if d >= self.max_depth:
                continue
            m = self.states[sid]
            row = []
            for (f, value) in self.transitions:
                m2 = step(m, f, value)
                row.append(-1 if m2 is None
                           else self._intern(m2, d + 1, work))
            self._rows[sid] = row
        # log AFTER the closure succeeds: an extend that raises
        # MemoOverflow latches the session terminal-UNKNOWN but the
        # session stays checkpointable — a log entry for the failed
        # call would make every restore of that checkpoint replay the
        # overflow and raise, turning the latched verdict into a
        # spurious error (and losing a released migration outright)
        self._log.append((tuple(transitions), self.max_depth))


def memo(model: Model, packed: PackedHistory,
         max_states: int = 1 << 20) -> MemoizedModel:
    """Memoize ``model`` over the distinct transitions of ``packed``
    (the reference's entry point, ``memo.clj:182-196``), with the BFS
    depth bounded by the history's invocation count."""
    from ..ops.op import INVOKE

    n_invokes = int(((packed.type == INVOKE) & ~packed.fails).sum())
    return memoize_model(model, transitions_of(packed), max_states,
                         max_depth=n_invokes)
