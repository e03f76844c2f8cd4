"""Fault injection — nemeses are Clients routed to process ``nemesis``
(``jepsen/nemesis.clj``).

Grudge-based partitioners: a *grudge* maps each node to the set of nodes
it should drop traffic from (``nemesis.clj:21-27``). Grudges:
``complete_grudge`` (``:41-54``), ``bridge`` (``:56-66``),
``majorities_ring`` (``:105-119``). Plus clock scrambling
(``:167-187``), SIGSTOP/SIGCONT process pauses (``:189-240``), and
f-routed composition (``:127-165``).

The counterpart of the JAX package's ``harness/nemesis.py``: host code;
the same commands reach a node's remote.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from .. import control
from ..control import net as net_ns
from . import client as client_ns


# the noop nemesis returns ops unchanged (``nemesis.clj:9-14``) — same
# contract as the pass-through client
Noop = client_ns.PassThrough
noop = client_ns.noop_nemesis


# --- grudges ---------------------------------------------------------------

def bisect(coll: Sequence) -> List[List]:
    """Cut in half, smaller half first (``nemesis.clj:29-32``)."""
    coll = list(coll)
    mid = len(coll) // 2
    return [coll[:mid], coll[mid:]]


def split_one(coll: Sequence, loner=None) -> List[List]:
    """One node vs the rest (``nemesis.clj:34-39``)."""
    coll = list(coll)
    if loner is None:
        loner = random.choice(coll)
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Sequence[Sequence]) -> Dict[Any, Set]:
    """No node may talk outside its component (``nemesis.clj:41-54``)."""
    comps = [set(c) for c in components]
    universe = set().union(*comps) if comps else set()
    grudge: Dict[Any, Set] = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def bridge(nodes: Sequence) -> Dict[Any, Set]:
    """Two halves plus one node with unbroken connectivity to both
    (``nemesis.clj:56-66``)."""
    components = bisect(list(nodes))
    b = components[1][0]
    grudge = complete_grudge(components)
    grudge.pop(b, None)
    return {n: (s - {b}) for n, s in grudge.items()}


def majority(n: int) -> int:
    return n // 2 + 1


def majorities_ring(nodes: Sequence) -> Dict[Any, Set]:
    """Every node sees a majority, but no two nodes see the same one
    (``nemesis.clj:105-119``): shuffle into a ring, each node keeps the
    next m-1 neighbors, drops the rest."""
    U = set(nodes)
    ring = list(nodes)
    random.shuffle(ring)
    n = len(ring)
    m = majority(n)
    grudge = {}
    for i in range(n):
        maj = {ring[(i + j) % n] for j in range(m)}
        grudge[ring[i]] = U - maj
    return grudge


# --- partitioner -----------------------------------------------------------

def _net(test: dict) -> net_ns.Net:
    return test.get("net", net_ns.noop)


def partition(test: dict, grudge: Dict[Any, Set]) -> None:
    """Apply a grudge: every node drops traffic from its grudge set.
    Cumulative — does not heal first (``nemesis.clj:16-27``)."""
    net = _net(test)
    def snub(test_, node):
        for src in grudge.get(node, ()):
            net.drop(test_, src, node)
    control.on_nodes(test, snub)


class Partitioner(client_ns.Client):
    """start: cut links per ``grudge_fn(nodes)``; stop: heal
    (``nemesis.clj:68-86``)."""

    def __init__(self, grudge_fn: Callable[[Sequence], Dict[Any, Set]]):
        self.grudge_fn = grudge_fn

    def setup(self, test, node):
        _net(test).heal(test)
        return self

    def invoke(self, test, op):
        if op["f"] == "start":
            grudge = self.grudge_fn(test.get("nodes") or [])
            partition(test, grudge)
            return {**op, "value": f"Cut off {sorted_grudge_str(grudge)}"}
        if op["f"] == "stop":
            _net(test).heal(test)
            return {**op, "value": "fully connected"}
        raise ValueError(f"partitioner can't handle f={op['f']!r}")

    def teardown(self, test):
        _net(test).heal(test)


def sorted_grudge_str(grudge: Dict[Any, Set]) -> str:
    return "{" + ", ".join(f"{n}: {sorted(map(str, s))}"
                           for n, s in sorted(grudge.items(),
                                              key=lambda kv: str(kv[0]))) \
        + "}"


def partitioner(grudge_fn) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """First-half/second-half split (``nemesis.clj:88-93``)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Randomly-chosen halves — the comdb2 tests' nemesis
    (``nemesis.clj:95-98``)."""
    def g(nodes):
        ns = list(nodes)
        random.shuffle(ns)
        return complete_grudge(bisect(ns))
    return Partitioner(g)


def partition_random_node() -> Partitioner:
    """Isolate one random node (``nemesis.clj:100-103``)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """Overlapping-majority ring partitions (``nemesis.clj:121-125``)."""
    return Partitioner(majorities_ring)


# --- composition -----------------------------------------------------------

class Compose(client_ns.Client):
    """Route ops to child nemeses by f (``nemesis.clj:127-165``).
    ``routes`` maps route-spec → nemesis, where a route-spec is either a
    set of fs (passed through unchanged) or a dict renaming outer f →
    inner f."""

    def __init__(self, routes):
        # routes: dict spec->nemesis, or (since dict/set specs aren't
        # hashable as keys) a sequence of (spec, nemesis) pairs
        pairs = routes.items() if isinstance(routes, dict) else routes
        self.routes = [(self._to_fn(spec), nem) for spec, nem in pairs]

    @staticmethod
    def _to_fn(spec):
        if isinstance(spec, (set, frozenset)):
            return lambda f: f if f in spec else None
        if isinstance(spec, dict):
            return lambda f: spec.get(f)
        if callable(spec):
            return spec
        raise TypeError(f"bad route spec {spec!r}")

    def setup(self, test, node):
        self.routes = [(fn, nem.setup(test, node))
                       for fn, nem in self.routes]
        return self

    def invoke(self, test, op):
        f = op.get("f")
        for fn, nem in self.routes:
            f2 = fn(f)
            if f2 is not None:
                out = nem.invoke(test, {**op, "f": f2})
                return {**out, "f": f}
        raise ValueError(f"no nemesis can handle {f!r}")

    def teardown(self, test):
        for _, nem in self.routes:
            nem.teardown(test)


def compose(routes) -> Compose:
    return Compose(routes)


# --- clock faults ----------------------------------------------------------

def set_time(t: float) -> str:
    """Set node time in POSIX seconds on the current session
    (``nemesis.clj:167-170``)."""
    return control.su("date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(client_ns.Client):
    """Randomizes node clocks within ±dt seconds
    (``nemesis.clj:172-187``)."""

    def __init__(self, dt: float):
        self.dt = dt

    def invoke(self, test, op):
        dt = self.dt
        def scramble(test_, node):
            return set_time(time.time() + random.uniform(-dt, dt))
        vals = control.on_nodes(test, scramble)
        return {**op, "value": vals}

    def teardown(self, test):
        def reset(test_, node):
            return set_time(time.time())
        try:
            control.on_nodes(test, reset)
        except Exception:
            pass


def clock_scrambler(dt: float) -> ClockScrambler:
    return ClockScrambler(dt)


# --- process pauses / node start-stop --------------------------------------

class NodeStartStopper(client_ns.Client):
    """start: run ``start_fn(test, node)`` on targeted nodes; stop: run
    ``stop_fn`` on the same nodes (``nemesis.clj:189-224``). The
    targeter picks fresh nodes each start."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes: Optional[List] = None
        self._lock = threading.Lock()

    def invoke(self, test, op):
        with self._lock:
            if op["f"] == "start":
                targets = self.targeter(test.get("nodes") or [])
                if targets is None:
                    return {**op, "value": "no-target"}
                if not isinstance(targets, (list, tuple, set)):
                    targets = [targets]
                targets = list(targets)
                if self._nodes is not None:
                    return {**op, "value":
                            f"nemesis already disrupting {self._nodes}"}
                self._nodes = targets
                vals = control.on_many(test, targets, self.start_fn)
                return {**op, "value": vals}
            if op["f"] == "stop":
                if self._nodes is None:
                    return {**op, "value": "not-started"}
                vals = control.on_many(test, self._nodes, self.stop_fn)
                self._nodes = None
                return {**op, "value": vals}
            raise ValueError(f"can't handle f={op['f']!r}")


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter=None) -> NodeStartStopper:
    """SIGSTOP/SIGCONT a process on random nodes
    (``nemesis.clj:226-240``)."""
    targeter = targeter or (lambda nodes: random.choice(list(nodes))
                            if nodes else None)

    def start(test, node):
        control.su("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        control.su("killall", "-s", "CONT", process)
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)
