"""WGL-style world search — the second checker engine.

The semantics of ``knossos/core.clj``: a *world* is a model state, a set
of pending invocations, and an index into the history (``core.clj:32-40``).
At each invocation the world forks into every permutation of every
subset of its pending ops (``possible-worlds``, ``core.clj:82-145``);
completions prune worlds that haven't linearized the op yet; a world
reaching the end of history short-circuits the search as valid
(``short-circuit!``, ``core.clj:334-340``).

Engineering mirrors the reference where it matters:

- degenerate-world dedup on (state, pending, index) (``core.clj:44-56``)
  with a bounded lossy seen-cache (the 24-bit cache, ``core.clj:261-279``)
- best-first scheduling by depth (priority −index, ``core.clj:342-345``)
- explorer threads over a shared queue (ncpu+2, ``core.clj:368-390``)
- the permutations-of-subsets expansion is computed as the closure of
  single-op linearizations with dedup — same reachable set, no factorial
  blowup on duplicate states

States come from the memoized model, so stepping is an array gather.
This engine is host-side by design (the frontier of *worlds* at
different indices doesn't batch the way the linear engine's per-op
configs do); the device engines (:mod:`.linear`) are the primary.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional, Sequence, Tuple, Union

from ..models.memo import MemoizedModel, memo as make_memo
from ..models.model import Model
from ..ops.op import INVOKE, OK, FAIL, INFO, Op
from ..ops.packed import PackedHistory, pack_history

VALID = True
UNKNOWN = "unknown"

# event kinds in the compiled schedule
E_SKIP = 0
E_INVOKE = 1
E_OK = 2


@dataclass
class WGLResult:
    valid: Union[bool, str]
    deepest_index: int = 0
    worlds_explored: int = 0
    cause: Optional[str] = None


def _compile_events(packed: PackedHistory) -> List[Tuple[int, int, int]]:
    """Per-op (kind, invocation-index, transition-id)."""
    events = []
    for i in range(len(packed)):
        t = int(packed.type[i])
        if t == INVOKE and not packed.fails[i]:
            events.append((E_INVOKE, i, int(packed.trans[i])))
        elif t == OK:
            inv = int(packed.pair[i])
            events.append((E_OK, inv, -1))
        else:
            events.append((E_SKIP, -1, -1))
    return events


def _linearization_closure(succ, state: int,
                           pending: FrozenSet[Tuple[int, int]]):
    """All (state', remaining-pending') reachable by linearizing any
    sequence of pending ops — the deduplicated form of
    permutations-of-subsets (``core.clj:82-145``). Pending entries are
    (invocation-index, transition-id) pairs."""
    seen = {(state, pending)}
    stack = [(state, pending)]
    while stack:
        s, p = stack.pop()
        for entry in p:
            _, tr = entry
            s2 = int(succ[s, tr])
            if s2 < 0:
                continue
            nxt = (s2, p - {entry})
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return seen


def check(mm: MemoizedModel, packed: PackedHistory,
          n_threads: Optional[int] = None,
          max_worlds: int = 1 << 22,
          seen_bits: int = 24) -> WGLResult:
    """Run the world search; returns a :class:`WGLResult`."""
    events = _compile_events(packed)
    n = len(events)
    succ = mm.succ
    if n == 0:
        return WGLResult(valid=True)

    n_threads = n_threads or min(32, (os.cpu_count() or 2) + 2)
    # lossy seen-cache, overwrite on collision (core.clj:261-279)
    seen_mask = (1 << seen_bits) - 1
    seen: List[Optional[Tuple]] = [None] * (seen_mask + 1)

    heap: List[Tuple[int, int, int, FrozenSet]] = []
    # entries: (-index, tiebreak, state, pending)
    counter = itertools.count()
    heapq.heappush(heap, (0, next(counter), 0, frozenset()))
    lock = threading.Lock()
    cond = threading.Condition(lock)
    stats = {"explored": 0, "deepest": 0, "active": 0,
             "result": None, "overflow": False}

    def offer(index: int, state: int, pending: FrozenSet) -> None:
        key = (index, state, pending)
        slot = hash(key) & seen_mask
        with cond:
            if seen[slot] == key:
                return
            seen[slot] = key
            heapq.heappush(heap,
                           (-index, next(counter), state, pending))
            cond.notify()

    def explore_one(index: int, state: int, pending: FrozenSet) -> None:
        """Advance a world until it forks, dies, or finishes."""
        while True:
            if index >= n:
                stats["result"] = True
                return
            kind, inv, tr = events[index]
            if kind == E_SKIP:
                index += 1
                continue
            if kind == E_OK:
                # completion: the op must already be linearized
                if any(e[0] == inv for e in pending):
                    return                      # world dies
                index += 1
                continue
            # invoke: fork into the linearization closure
            pending2 = pending | {(inv, tr)}
            outcomes = _linearization_closure(succ, state, pending2)
            if len(outcomes) == 1:
                (state, pending) = next(iter(outcomes))
                index += 1
                continue
            first = True
            for (s2, p2) in outcomes:
                if first:
                    nxt = (s2, p2)
                    first = False
                else:
                    offer(index + 1, s2, p2)
            (state, pending) = nxt
            index += 1

    def explorer():
        while True:
            with cond:
                while not heap and stats["active"] > 0 \
                        and stats["result"] is None \
                        and not stats["overflow"]:
                    cond.wait(0.05)
                if stats["result"] is not None or stats["overflow"]:
                    cond.notify_all()
                    return
                if not heap:
                    if stats["active"] == 0:
                        cond.notify_all()
                        return
                    continue
                negi, _, state, pending = heapq.heappop(heap)
                stats["active"] += 1
                stats["explored"] += 1
                stats["deepest"] = max(stats["deepest"], -negi)
                if stats["explored"] > max_worlds:
                    stats["overflow"] = True
                    stats["active"] -= 1
                    cond.notify_all()
                    return
            try:
                explore_one(-negi, state, pending)
            finally:
                with cond:
                    stats["active"] -= 1
                    cond.notify_all()

    threads = [threading.Thread(target=explorer, daemon=True,
                                name=f"wgl-{i}")
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if stats["result"] is True:
        return WGLResult(valid=True, deepest_index=n,
                         worlds_explored=stats["explored"])
    if stats["overflow"]:
        return WGLResult(valid=UNKNOWN, deepest_index=stats["deepest"],
                         worlds_explored=stats["explored"],
                         cause="world budget exhausted")
    return WGLResult(valid=False, deepest_index=stats["deepest"],
                     worlds_explored=stats["explored"])


def analysis(model: Model, history: Sequence[Op],
             **kw) -> dict:
    """``knossos.core/analysis`` equivalent (``core.clj:484-512``):
    returns {"valid?", "deepest-index", "worlds-explored"}."""
    packed = (history if isinstance(history, PackedHistory)
              else pack_history(list(history)))
    if len(packed) == 0:
        return {"valid?": True, "deepest-index": 0, "worlds-explored": 0}
    mm = make_memo(model, packed)
    r = check(mm, packed, **kw)
    out = {"valid?": r.valid, "deepest-index": r.deepest_index,
           "worlds-explored": r.worlds_explored}
    if r.cause:
        out["cause"] = r.cause
    return out
