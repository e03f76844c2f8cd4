"""Synthetic concurrent-history generation for checker validation and
benchmarks.

Simulates N single-threaded processes against a genuinely atomic
register: each in-flight op takes effect at one random instant between
its invoke and its completion, so generated histories are linearizable
by construction. ``mutate`` then corrupts completions to produce
mostly-invalid variants. This plays the role the reference fills with
recorded known-good/known-bad EDN histories (`linearizable/filetest/`).

Same generator as the JAX package's, draw for draw: the same
``random.Random`` seed gives the same history in both packages.
"""

from __future__ import annotations

import random
from typing import List, Optional

from . import op as O


class _Proc:
    __slots__ = ("name", "f", "value", "applied", "result")

    def __init__(self, name):
        self.name = name
        self.f = None          # in-flight op, or None if idle
        self.value = None
        self.applied = False
        self.result = None


def register_history(rng: random.Random, n_procs: int = 3, n_events: int = 12,
                     values: int = 3, fs=("read", "write", "cas"),
                     p_info: float = 0.05,
                     max_pending: Optional[int] = None) -> List[O.Op]:
    """A linearizable cas-register history with ~``n_events`` total ops.

    ``max_pending`` caps how many ops are in flight at once without
    narrowing the process table — wide-concurrency tests (the
    reference CLI default is 30 threads, ``cli.clj:52-91``) need wide
    slot tensors, but an op mix where half of 30 threads sit pending
    at every instant is a frontier the *reference* can't search either;
    real harness runs complete ops in milliseconds against a seconds-
    scale stagger, so in-flight stays far below thread count."""
    state: Optional[int] = None
    procs = [_Proc(i) for i in range(n_procs)]
    next_pid = n_procs
    h: List[O.Op] = []
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
            h.append(O.invoke(pr.name, pr.f, pr.value))
        elif not pr.applied:
            # linearization point: the op takes effect now
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
                # crashed op: :info retires the process id; a fresh one
                # takes over the thread (jepsen/core.clj:178-200)
                h.append(O.info(pr.name, pr.f, pr.value))
                pr.name = next_pid
                next_pid += 1
            else:
                typ, v = pr.result
                h.append(O.Op(pr.name, typ, pr.f,
                              v if typ == "ok" else pr.value))
            pr.f = None
    # leave any still-in-flight ops pending (indeterminate) — that's legal
    return h


def mutate(rng: random.Random, history: List[O.Op],
           values: int = 3) -> List[O.Op]:
    """Corrupt one completed read/write value; usually breaks validity."""
    h = [op.with_() for op in history]
    oks = [i for i, op in enumerate(h) if op.type == "ok"]
    if not oks:
        return h
    i = rng.choice(oks)
    op = h[i]
    if op.f == "cas":
        a, b = op.value if op.value else (0, 0)
        h[i] = op.with_(value=((a + 1) % values, b))
    else:
        v = op.value if isinstance(op.value, int) else 0
        h[i] = op.with_(value=(v + 1) % values)
    return h


def pinned_wide_history(n_pinned: int = 18,
                        with_reads: bool = True) -> List[O.Op]:
    """A history whose EFFECTIVE slot count (max concurrent open
    calls, post slot-renaming) is ``n_pinned``+1 while the search
    frontier stays tiny: each pinned slot is a crashed (:info) cas
    whose expected value (9) is unreachable — forever open, so it
    holds its slot, but it can never linearize, so it forks no
    configs. It drives the wide-P engines (the multi-word PackPlan
    dedup) past the segment-search kernel's gate."""
    h: List[O.Op] = []
    for i in range(n_pinned):
        h.append(O.invoke(2000 + i, "cas", (9, 1)))   # 9 unreachable
        h.append(O.info(2000 + i, "cas", (9, 1)))
        p = i % 3
        h.append(O.invoke(p, "write", i % 4))
        h.append(O.ok(p, "write", i % 4))
        if with_reads:
            h.append(O.invoke(p, "read", None))
            h.append(O.ok(p, "read", i % 4))
    return h


def concurrent_writes(k: int) -> List[O.Op]:
    """``k`` processes each write a distinct value (1..k) at once, then
    all return: a linearizable history whose first segment's closure
    grows by the i-subsets of the writes (each with every possible last
    writer) at step i, each config reached along several paths — the
    segment-search kernel's widest merges (k = 6, 7) and, at k = 8, more
    new candidates than it merges in registers."""
    h = ([O.invoke(p, "write", p + 1) for p in range(k)]
         + [O.ok(p, "write", p + 1) for p in range(k)])
    return [op.with_(index=i) for i, op in enumerate(h)]
