"""Synthetic concurrent-history generation for checker validation and
benchmarks.

Simulates N single-threaded processes against a genuinely atomic
register: each in-flight op takes effect at one random instant between
its invoke and its completion, so generated histories are linearizable
by construction. ``mutate`` then corrupts completions to produce
mostly-invalid variants. This plays the role the reference fills with
recorded known-good/known-bad EDN histories (`linearizable/filetest/`).

Same generators as the JAX package's, draw for draw: the same
``random.Random`` seed gives the same history in both packages
(register histories, and list-append txn histories with
:func:`list_append_history`; :func:`txn_anomaly_history` gives one
fixed history per Adya anomaly class).
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


def list_append_history(rng: random.Random, n_procs: int = 3,
                        n_txns: int = 12, n_keys: int = 3,
                        max_micro: int = 4, p_info: float = 0.0,
                        p_fail: float = 0.0) -> List[O.Op]:
    """A serializable-by-construction list-append txn history: each
    in-flight txn applies atomically at one random instant between
    its invoke and completion (so the serial order extends realtime —
    strictly serializable), reads return whole lists (version order
    is recoverable Elle-style), and appended values are unique per
    key. ``p_fail`` aborts a txn at its would-be apply point (nothing
    applies); ``p_info`` loses a completion after apply
    (indeterminate, writes visible)."""
    store = {k: [] for k in range(n_keys)}
    next_val = [0] * n_keys
    procs = [_Proc(i) for i in range(n_procs)]
    next_pid = n_procs
    started = 0
    h: List[O.Op] = []

    def plan(pr):
        mops = []
        for _ in range(rng.randrange(1, max_micro + 1)):
            k = rng.randrange(n_keys)
            if rng.random() < 0.5:
                mops.append(["append", k, None])   # value at apply
            else:
                mops.append(["r", k, None])
        pr.value = mops

    while True:
        open_ = [p for p in procs if p.f is not None]
        if started >= n_txns and not open_:
            break
        pr = rng.choice(open_ or procs) if started >= n_txns \
            else rng.choice(procs)
        if pr.f is None:
            pr.f = "txn"
            pr.applied = False
            plan(pr)
            h.append(O.invoke(
                pr.name, "txn",
                tuple((f, k, None) for f, k, _ in pr.value)))
            started += 1
        elif not pr.applied:
            pr.applied = True
            if p_fail and rng.random() < p_fail:
                pr.result = ("fail", tuple(
                    (f, k, None) for f, k, _ in pr.value))
                continue
            done = []
            for f, k, _ in pr.value:
                if f == "append":
                    v = next_val[k]
                    next_val[k] += 1
                    store[k].append(v)
                    done.append(("append", k, v))
                else:
                    done.append(("r", k, tuple(store[k])))
            pr.result = ("ok", tuple(done))
        else:
            typ, val = pr.result
            if p_info and rng.random() < p_info:
                h.append(O.info(pr.name, "txn", val))
                pr.name = next_pid
                next_pid += 1
            else:
                h.append(O.Op(pr.name, typ, "txn", val))
            pr.f = None
    return h


def txn_anomaly_history(kind: str) -> List[O.Op]:
    """Deterministic seeded txn histories, one per Adya anomaly class
    — the known-bad fixtures the serializability checker's tests and
    the check.sh smoke gate on. ``clean`` is the known-good twin."""
    def txn(p, mops, typ="ok"):
        inv = tuple((f, k, None if f == "r" else v) for f, k, v in mops)
        return [O.invoke(p, "txn", inv),
                O.Op(p, typ, "txn", tuple(mops))]

    if kind == "clean":
        return (txn(0, [("append", 0, 1)])
                + txn(1, [("r", 0, (1,)), ("append", 0, 2)])
                + txn(2, [("r", 0, (1, 2))]))
    if kind == "g0":
        # final reads disagree on who wrote first: ww cycle t0 <-> t1
        return (txn(0, [("append", 0, 1), ("append", 1, 2)])
                + txn(1, [("append", 0, 3), ("append", 1, 4)])
                + txn(2, [("r", 0, (1, 3)), ("r", 1, (4, 2))]))
    if kind == "g1c":
        # each txn reads the OTHER's append: wr cycle
        return (txn(0, [("append", 0, 1), ("r", 1, (2,))])
                + txn(1, [("append", 1, 2), ("r", 0, (1,))]))
    if kind == "g1a":
        # a failed txn's append observed by a committed read
        return (txn(0, [("append", 0, 1)], typ="fail")
                + txn(1, [("r", 0, (1,))]))
    if kind == "g2-item":
        # write skew: both read empty, each appends the other's key
        return (txn(0, [("r", 0, ()), ("append", 1, 1)])
                + txn(1, [("r", 1, ()), ("append", 0, 2)])
                + txn(2, [("r", 0, (2,)), ("r", 1, (1,))]))
    if kind == "duplicate":
        # the -D no-dedup shape: one append observed twice
        return (txn(0, [("append", 0, 1)])
                + txn(1, [("r", 0, (1, 1))]))
    raise ValueError(f"unknown anomaly kind {kind!r}")


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
