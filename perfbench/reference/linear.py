"""The plain reference: linearizability of a cas-register history.

Knossos' just-in-time linearization (``knossos/linear.clj``), written
from its description in plain Python, independent of the program under
test. It imports nothing of the program and reads the generators' plain
tuples ``(process, type, f, value)``.

Semantics, as Knossos' ``cas-register`` model and history completion
give them: the register starts at nil; ``write v`` sets it; ``cas (e,
n)`` needs the value ``e`` and sets ``n``; ``read v`` needs ``v``, and a
read of nil is a wildcard. An ok completion's value fills in its
invocation; an invocation whose completion is ``fail`` never happened;
one whose completion is ``info`` (or that has none) stays pending for
ever. A config is the register's value and, per open call, whether it
is pending or already linearized. At each ok completion the frontier of
configs is closed under linearizing pending calls, one round at a time,
for at most as many rounds as calls are open, stopping at a fixed
point; then only the configs in which the completing call has taken
effect survive. An empty frontier is INVALID at that completion's index
in the history; the closed frontier there (before the completing call's
filter) and the calls open there are the counterexample that the
program's report is judged against.

Besides the verdict, :func:`check` counts what the search needs, for
the roofline of the program's segment-search kernel: the frontier size
``n`` at the start of each closure round (the rounds in order, over the
whole history), the effective slot count (the most calls open at once,
a freed slot reused), the completions searched and the most invocations
between two completions.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Sequence, Tuple

IDLE, LIN = 0, 1
_DEAD = object()          # a step the model forbids


@dataclass
class Verdict:
    """``valid`` and, when INVALID, the index of the completion at
    which the frontier died. The counts feed :mod:`perfbench.lib.roofline`."""
    valid: bool
    op_index: Optional[int]
    ops: int                       # invocations: the checked operations
    slots: int                     # effective slot count
    segments: int                  # completions searched
    max_invokes: int               # most invocations before one completion
    rounds: List[int]              # frontier size at each closure round
    states: int                    # register values the calls can set, nil too
    transitions: int               # distinct (f, value) calls
    #: when INVALID, the closed frontier at the failing completion, each
    #: config ``(value, frozenset((process, "linearized" | (f, value))))``
    #: over its open calls, and the open calls ``(process, f, value)``
    dead: FrozenSet[tuple] = frozenset()
    open_calls: FrozenSet[tuple] = frozenset()


def _step(state, f, value):
    if f == "write":
        return value
    if f == "cas":
        expected, new = value
        return new if state == expected else _DEAD
    if f == "read":
        return state if value is None or value == state else _DEAD
    return _DEAD


def complete(history: Sequence[tuple]) -> Tuple[list, int]:
    """Per event, ``("invoke", slot, (f, value), process)``, ``("ok", slot)`` or
    None (a failed call, an info, an event after the last ok), and the
    effective slot count. Slots are taken lowest-free at an invocation
    and freed after its ok."""
    n = len(history)
    last_ok = max((i for i, op in enumerate(history) if op[1] == "ok"),
                  default=-1)
    done = {}                      # invoke index -> (type, value)
    open_at = {}
    for i, (p, typ, f, v) in enumerate(history):
        if typ == "invoke":
            if p in open_at:
                raise ValueError(f"process {p!r} invokes at {i} while "
                                 "a call is open")
            open_at[p] = i
        elif typ in ("ok", "fail", "info"):
            j = open_at.pop(p, None)
            if j is None:
                if typ == "ok":
                    raise ValueError(f"ok without invocation at {i}")
                continue
            done[j] = (typ, v)
    events: list = [None] * n
    slot_of = {}
    free: List[int] = []
    width = 0
    for i, (p, typ, f, v) in enumerate(history):
        if i > last_ok:
            break
        if typ == "invoke":
            kind, value = done.get(i, ("info", v))
            if kind == "fail":
                continue
            if kind == "ok":
                v = value
            if free:
                free.sort()
                q = free.pop(0)
            else:
                q = width
                width += 1
            slot_of[p] = q
            events[i] = ("invoke", q, (f, v), p)
        elif typ == "ok":
            q = slot_of.pop(p)
            events[i] = ("ok", q)
            free.append(q)
    return events, width


class Search:
    """The search's state between events."""

    def __init__(self, width: int):
        self.width = width
        self.frontier = {(None, (IDLE,) * width)}
        self.codes: dict = {}               # (f, value) -> code
        self.ops: list = [None, None]       # code -> (f, value)
        self.owner: list = [None] * width   # slot -> process of its call
        self.call: list = [IDLE] * width    # slot -> code of its open call
        self.open_calls = 0
        self.segments = 0
        self.run = 0
        self.max_run = 0
        self.rounds: List[int] = []
        self.dead: frozenset = frozenset()
        self.open_at_death: frozenset = frozenset()

    def feed(self, events: list) -> Optional[int]:
        """Search ``events``; the index of the completion at which the
        frontier died, or None."""
        frontier = self.frontier
        ops, rounds = self.ops, self.rounds
        for i, ev in enumerate(events):
            if ev is None:
                continue
            if ev[0] == "invoke":
                _, q, op, p = ev
                c = self.codes.get(op)
                if c is None:
                    c = self.codes[op] = len(ops)
                    ops.append(op)
                frontier = {(s, sl[:q] + (c,) + sl[q + 1:])
                            for s, sl in frontier}
                self.owner[q], self.call[q] = p, c
                self.open_calls += 1
                self.run += 1
                continue
            _, q = ev
            self.segments += 1
            self.max_run = max(self.max_run, self.run)
            self.run = 0
            new = frontier
            for _ in range(self.open_calls):
                rounds.append(len(frontier))
                cand = set()
                for s, sl in new:
                    for qq, c in enumerate(sl):
                        if c > LIN:
                            s2 = _step(s, *ops[c])
                            if s2 is not _DEAD:
                                cand.add((s2, sl[:qq] + (LIN,)
                                          + sl[qq + 1:]))
                cand -= frontier
                if not cand:
                    break
                frontier |= cand
                new = cand
            closed = frontier
            frontier = {(s, sl[:q] + (IDLE,) + sl[q + 1:])
                        for s, sl in frontier if sl[q] == LIN}
            if not frontier:
                self.dead = frozenset(self._named(c) for c in closed)
                self.open_at_death = frozenset(
                    (self.owner[qq], *ops[c])
                    for qq, c in enumerate(self.call) if c != IDLE)
                self.frontier = frontier
                return i
            self.call[q] = IDLE
            self.open_calls -= 1
        self.frontier = frontier
        return None

    def _named(self, config) -> tuple:
        """A config over processes: its value and, per open call, its
        process and ``"linearized"`` or its ``(f, value)``."""
        s, sl = config
        return (s, frozenset(
            (self.owner[q], "linearized" if c == LIN else self.ops[c])
            for q, c in enumerate(sl) if c != IDLE))


def check(history: Sequence[tuple]) -> Verdict:
    """Check one history; see the module docstring."""
    events, width = complete(history)
    s = Search(width)
    fail = s.feed(events)
    ops = sum(1 for op in history if op[1] == "invoke")
    states = {None} | {v if f == "write" else v[1]
                       for f, v in s.codes if f in ("write", "cas")}
    return Verdict(fail is None, fail, ops, width, s.segments,
                   s.max_run, s.rounds, len(states), len(s.codes),
                   s.dead, s.open_at_death)


#: the program's description of a cas-register state
_STATE = re.compile(r"^CASRegister\(value=(.*)\)$")
#: a report lists at most this many configs
REPORTED_CONFIGS = 10


def _value(described):
    m = _STATE.match(described) if isinstance(described, str) else None
    if m is None:
        raise ValueError(f"not a register state: {described!r}")
    return ast.literal_eval(m.group(1))


def _plain(x):
    return tuple(map(_plain, x)) if isinstance(x, (list, tuple)) else x


def report_faults(v: Verdict, configs, paths) -> List[str]:
    """What is wrong with the program's report of an INVALID history
    whose verdict and index agree with ``v``; empty where it is sound.

    ``configs`` (``{"model": ..., "pending": {process: "linearized" |
    (f, value)}}``) has to hold ``min(10, len(v.dead))`` configs, each
    one of the reference's closed frontier at the failing completion.
    ``paths`` (lists of ``{"op": ..., "model": ...}``) has to hold at
    least one path; each starts from the value of a config there, steps
    through calls open there, each step to the value the model gives,
    and ends in the one step that the model forbids (``"inconsistent"``).
    """
    faults = []
    try:
        got = {(_value(c["model"]), frozenset(
            (p, st if st == "linearized" else _plain(st))
            for p, st in c["pending"].items())) for c in configs or ()}
    except (KeyError, TypeError, ValueError, SyntaxError) as e:
        return [f"a config does not read: {e}"]
    if len(configs or ()) != min(REPORTED_CONFIGS, len(v.dead)):
        faults.append(f"{len(configs or ())} configs, not "
                      f"{min(REPORTED_CONFIGS, len(v.dead))}")
    if not got <= v.dead:
        faults.append(f"{len(got - v.dead)} configs outside the frontier")
    if not paths:
        faults.append("no path")
    values = {s for s, _ in v.dead}
    for path in paths or ():
        try:
            s = _value(path[0]["model"])
            steps = path[1:]
            ok = s in values and bool(steps)
            for j, e in enumerate(steps):
                f, value = e["op"]["f"], _plain(e["op"]["value"])
                ok &= (e["op"]["process"], f, value) in v.open_calls
                s = _step(s, f, value)
                if j == len(steps) - 1:
                    ok &= s is _DEAD and e["model"] == "inconsistent"
                else:
                    ok &= s is not _DEAD and s == _value(e["model"])
                if not ok:
                    break
        except (KeyError, TypeError, ValueError, SyntaxError, IndexError):
            ok = False
        if not ok:
            faults.append(f"path {path!r:.200} does not replay")
    return faults
