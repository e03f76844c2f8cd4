"""Frozen traffic generators: Jepsen cas-register histories.

A copy, draw for draw, of ``register_history`` as the port's
``ops/synth.py`` had it when this benchmark was written, so that a later
change to the program cannot change the benchmark's inputs. An
op is a plain tuple ``(process, type, f, value)`` with ``type`` one of
``"invoke"``, ``"ok"``, ``"fail"``, ``"info"``; the traffic callers turn
them into the program's own op objects during set-up, and the plain
reference reads the tuples as they are.

N single-threaded processes run against an atomic register: each op
takes effect at one random instant between its invoke and its
completion, so a history is linearizable by construction.
:func:`plant_read` makes one INVALID.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

Op = Tuple[object, str, str, object]


class _Proc:
    __slots__ = ("name", "f", "value", "applied", "result")

    def __init__(self, name):
        self.name = name
        self.f = None
        self.value = None
        self.applied = False
        self.result = None


def register_history(rng: random.Random, n_procs: int = 3,
                     n_events: int = 12, values: int = 3,
                     fs: Sequence[str] = ("read", "write", "cas"),
                     p_info: float = 0.05,
                     max_pending: Optional[int] = None) -> List[Op]:
    """A linearizable cas-register history of ``n_events`` events."""
    state = None
    procs = [_Proc(i) for i in range(n_procs)]
    next_pid = n_procs
    h: List[Op] = []
    while len(h) < n_events:
        pool = procs
        if max_pending is not None:
            pending = [p for p in procs if p.f is not None]
            if len(pending) >= max_pending:
                pool = pending
        pr = rng.choice(pool)
        if pr.f is None:
            pr.f = rng.choice(fs)
            pr.applied = False
            if pr.f == "read":
                pr.value = None
            elif pr.f == "write":
                pr.value = rng.randrange(values)
            else:
                pr.value = (rng.randrange(values), rng.randrange(values))
            h.append((pr.name, "invoke", pr.f, pr.value))
        elif not pr.applied:
            pr.applied = True
            if pr.f == "read":
                pr.result = ("ok", state)
            elif pr.f == "write":
                state = pr.value
                pr.result = ("ok", pr.value)
            else:
                expected, new = pr.value
                if state == expected:
                    state = new
                    pr.result = ("ok", pr.value)
                else:
                    pr.result = ("fail", pr.value)
        else:
            if rng.random() < p_info:
                h.append((pr.name, "info", pr.f, pr.value))
                pr.name = next_pid
                next_pid += 1
            else:
                typ, v = pr.result
                h.append((pr.name, typ, pr.f,
                          v if typ == "ok" else pr.value))
            pr.f = None
    return h


def plant_read(rng: random.Random, history: List[Op], values: int,
               tail: float) -> Tuple[List[Op], int]:
    """The history with one read, drawn from those that complete in the
    last ``tail`` share of the events, answered with ``values``: a value
    that no write or cas of ``range(values)`` puts. So the history is
    INVALID at that read's completion and nowhere before it (the rest
    stays linearizable with the read left pending), found without a
    search, whatever the seed; returns it and that completion's index."""
    k = len(history) - max(int(len(history) * tail), 1)
    reads = [i for i in range(k, len(history))
             if history[i][1] == "ok" and history[i][2] == "read"]
    if not reads:
        raise ValueError("no read completes in the history's tail")
    i = rng.choice(reads)
    p, typ, f, _ = history[i]
    return history[:i] + [(p, typ, f, values)] + history[i + 1:], i
