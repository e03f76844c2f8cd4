"""Generator DSL — composable, thread-safe op sources.

The semantics of ``jepsen/generator.clj``: a generator yields operation
maps for processes until exhausted, at which point it yields ``None``.
Every plain object acts as a constant generator of itself; callables are
invoked with ``(test, process)`` (or no args); ``None`` is the empty
generator (``generator.clj:22-38``).

The dynamic ``*threads*`` binding (``generator.clj:40``) — the ordered
set of worker threads routed into a subtree, used by ``on``/``reserve``/
``synchronize`` — is a per-OS-thread binding stack here, since each
harness worker draws ops on its own thread.

The counterpart of the JAX package's ``harness/generator.py``: host code
drawing from the stdlib ``random`` module in the same order, so a seeded
single-threaded drive of either package's generator gives the same ops.
"""

from __future__ import annotations

import inspect
import random
import threading
import time as _time
from typing import Any, Callable, List, Optional, Sequence

NEMESIS = "nemesis"

_tls = threading.local()


def current_threads() -> Optional[List]:
    return getattr(_tls, "threads", None)


class _ThreadsBinding:
    def __init__(self, threads):
        self.threads = list(threads)

    def __enter__(self):
        self.saved = getattr(_tls, "threads", None)
        _tls.threads = self.threads
        return self

    def __exit__(self, *exc):
        _tls.threads = self.saved


def with_threads(threads):
    """Bind the ordered thread collection for the current OS thread
    (``generator.clj:46-53``)."""
    return _ThreadsBinding(threads)


def process_to_thread(test: dict, process) -> Any:
    """process mod concurrency for integer processes; symbolic processes
    (the nemesis) map to themselves (``generator.clj:55-60``)."""
    if isinstance(process, int) and not isinstance(process, bool):
        return process % test["concurrency"]
    return process


def process_to_node(test: dict, process):
    thread = process_to_thread(test, process)
    nodes = test.get("nodes") or []
    if isinstance(thread, int) and nodes:
        return nodes[thread % len(nodes)]
    return None


def op(gen, test: dict, process):
    """Draw one operation from anything generator-like
    (``generator.clj:22-38``): Generator → its op; None → None;
    callable → call it; any other object → itself (a constant op)."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.op(test, process)
    if callable(gen):
        # decide arity by signature, not by catching TypeError — a
        # TypeError raised *inside* the fn must propagate, not trigger
        # a confusing zero-arg retry
        try:
            inspect.signature(gen).bind(test, process)
        except TypeError:
            return gen()
        return gen(test, process)
    return gen


class Generator:
    """Subclasses implement ``op(test, process) -> op-dict | None``."""

    def op(self, test: dict, process):
        raise NotImplementedError


class _Fn(Generator):
    def __init__(self, fn: Callable):
        self.fn = fn

    def op(self, test, process):
        return self.fn(test, process)


class Void(Generator):
    """Terminates immediately (``generator.clj:62-65``)."""

    def op(self, test, process):
        return None


void = Void()


class DelayFn(Generator):
    """Each op takes ``f()`` extra seconds (``generator.clj:90-96``)."""

    def __init__(self, f: Callable[[], float], gen):
        self.f = f
        self.gen = gen

    def op(self, test, process):
        _time.sleep(self.f())
        return op(self.gen, test, process)


def delay(dt: float, gen) -> DelayFn:
    return DelayFn(lambda: dt, gen)


def stagger(dt: float, gen) -> DelayFn:
    """Uniform random delay with mean dt, in [0, 2dt)
    (``generator.clj:137-141``)."""
    return DelayFn(lambda: random.uniform(0, 2 * dt), gen)


class DelayTil(Generator):
    """Emit ops as close as possible to multiples of dt seconds from an
    anchor — for triggering races (``generator.clj:112-135``)."""

    def __init__(self, dt: float, gen, precache: bool = True):
        self.dt = dt
        self.gen = gen
        self.precache = precache
        self.anchor = _time.monotonic()

    def _sleep_til_tick(self):
        now = _time.monotonic()
        since = (now - self.anchor) % self.dt
        _time.sleep(self.dt - since)

    def op(self, test, process):
        if self.precache:
            o = op(self.gen, test, process)
            self._sleep_til_tick()
            return o
        self._sleep_til_tick()
        return op(self.gen, test, process)


def delay_til(dt: float, gen, precache: bool = True) -> DelayTil:
    return DelayTil(dt, gen, precache)


def sleep(dt: float) -> DelayFn:
    """Takes dt seconds, always yields None (``generator.clj:143-146``)."""
    return delay(dt, void)


class Once(Generator):
    """Passes through the source exactly once (``generator.clj:148-156``)."""

    def __init__(self, source):
        self.source = source
        self._lock = threading.Lock()
        self._emitted = False

    def op(self, test, process):
        with self._lock:
            if self._emitted:
                return None
            self._emitted = True
        return op(self.source, test, process)


def once(source) -> Once:
    return Once(source)


class Log(Generator):
    """Logs a message every invocation, yields None
    (``generator.clj:158-164``)."""

    def __init__(self, msg, sink: Optional[Callable[[str], None]] = None):
        self.msg = msg
        self.sink = sink

    def op(self, test, process):
        import logging
        sink = self.sink or logging.getLogger("comdb2_tpu_torch.harness").info
        sink(self.msg)
        return None


def log_star(msg) -> Log:
    return Log(msg)


def log(msg) -> Once:
    """Logs once (``generator.clj:166-169``)."""
    return once(Log(msg))


class Each(Generator):
    """A fresh generator from ``gen_fn`` per distinct process
    (``generator.clj:171-186``)."""

    def __init__(self, gen_fn: Callable[[], Any]):
        self.gen_fn = gen_fn
        self._lock = threading.Lock()
        self._gens = {}

    def op(self, test, process):
        with self._lock:
            if process not in self._gens:
                self._gens[process] = self.gen_fn()
            g = self._gens[process]
        return op(g, test, process)


def each(gen_fn: Callable[[], Any]) -> Each:
    return Each(gen_fn)


class Seq(Generator):
    """One op from each generator in turn; a None moves to the next;
    exhausted when the sequence is (``generator.clj:188-200``)."""

    def __init__(self, coll):
        self._iter = iter(coll)
        self._lock = threading.Lock()
        self._cur = None
        self._done = False

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                try:
                    self._cur = next(self._iter)
                except StopIteration:
                    self._done = True
                    return None
                g = self._cur
            o = op(g, test, process)
            if o is not None:
                return o


def seq(coll) -> Seq:
    return Seq(coll)


def start_stop(t1: float, t2: float) -> Seq:
    """start after t1 s, stop after t2 s more (``generator.clj:202-209``)."""
    return seq([sleep(t1), {"type": "info", "f": "start"},
                sleep(t2), {"type": "info", "f": "stop"}])


class Mix(Generator):
    """Uniform random choice between generators (``generator.clj:211-217``)."""

    def __init__(self, gens: Sequence):
        self.gens = list(gens)

    def op(self, test, process):
        return op(random.choice(self.gens), test, process)


def mix(gens) -> Mix:
    return Mix(gens)


def cas_gen(test=None, process=None):
    """Random read/write/cas invocations over ints < 5
    (``generator.clj:219-231``)."""
    r = random.random()
    if r > 0.66:
        return {"type": "invoke", "f": "read", "value": None}
    if r > 0.33:
        return {"type": "invoke", "f": "write", "value": random.randrange(5)}
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


class QueueGen(Generator):
    """Random enqueue (consecutive ints) / dequeue mix
    (``generator.clj:233-243``)."""

    def __init__(self):
        self._i = -1
        self._lock = threading.Lock()

    def op(self, test, process):
        if random.random() < 0.5:
            with self._lock:
                self._i += 1
                v = self._i
            return {"type": "invoke", "f": "enqueue", "value": v}
        return {"type": "invoke", "f": "dequeue", "value": None}


def queue_gen() -> QueueGen:
    return QueueGen()


class DrainQueue(Generator):
    """After the source is exhausted, emit enough dequeues to drain every
    attempted enqueue (``generator.clj:245-259``)."""

    def __init__(self, gen):
        self.gen = gen
        self._outstanding = 0
        self._lock = threading.Lock()

    def op(self, test, process):
        # draw + counter update under one lock: otherwise a thread that
        # sees the source exhausted can decrement before a concurrent
        # enqueue's increment lands and under-drain the queue
        with self._lock:
            o = op(self.gen, test, process)
            if o is not None:
                if o.get("f") == "enqueue":
                    self._outstanding += 1
                return o
            self._outstanding -= 1
            remaining = self._outstanding
        if remaining >= 0:
            return {"type": "invoke", "f": "dequeue", "value": None}
        return None


def drain_queue(gen) -> DrainQueue:
    return DrainQueue(gen)


class Limit(Generator):
    """Only n operations pass through (``generator.clj:261-267``)."""

    def __init__(self, n: int, gen):
        self.gen = gen
        self._life = n
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._life <= 0:
                return None
            self._life -= 1
        return op(self.gen, test, process)


def limit(n: int, gen) -> Limit:
    return Limit(n, gen)


class TimeLimit(Generator):
    """Ops until dt seconds elapse, measured from the first draw
    (``generator.clj:269-279``)."""

    def __init__(self, dt: float, source):
        self.dt = dt
        self.source = source
        self._deadline = None
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._deadline is None:
                self._deadline = _time.monotonic() + self.dt
        if _time.monotonic() <= self._deadline:
            return op(self.source, test, process)
        return None


def time_limit(dt: float, source) -> TimeLimit:
    return TimeLimit(dt, source)


class Filter(Generator):
    """Only ops satisfying pred; draws again otherwise
    (``generator.clj:281-290``)."""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = gen

    def op(self, test, process):
        while True:
            o = op(self.gen, test, process)
            if o is None:
                return None
            if self.pred(o):
                return o


def filter_gen(pred, gen) -> Filter:
    return Filter(pred, gen)


class On(Generator):
    """Forward to the source iff ``f(thread)``; rebinds the visible
    thread set to the matching subset (``generator.clj:292-300``)."""

    def __init__(self, f, source):
        self.f = f
        self.source = source

    def op(self, test, process):
        thread = process_to_thread(test, process)
        if not self.f(thread):
            return None
        ts = current_threads()
        sub = [t for t in ts if self.f(t)] if ts is not None else None
        if sub is None:
            return op(self.source, test, process)
        with with_threads(sub):
            return op(self.source, test, process)


def on(f, source) -> On:
    return On(f, source)


class Reserve(Generator):
    """(reserve n1 gen1 n2 gen2 ... default): the first n1 threads draw
    from gen1, the next n2 from gen2, the rest from default; each subtree
    sees only its own threads (``generator.clj:302-339``)."""

    def __init__(self, *args):
        assert args, "reserve needs a default generator"
        *pairs, self.default = args
        assert len(pairs) % 2 == 0, "reserve takes count/gen pairs + default"
        self.ranges = []
        n = 0
        for i in range(0, len(pairs), 2):
            cnt, gen = pairs[i], pairs[i + 1]
            self.ranges.append((n, n + cnt, gen))
            n += cnt

    def op(self, test, process):
        threads = list(current_threads() or
                       range(test["concurrency"]))
        thread = process_to_thread(test, process)
        try:
            idx = threads.index(thread)
        except ValueError:
            idx = thread if isinstance(thread, int) else 0
        for lo, hi, gen in self.ranges:
            if idx < hi:
                with with_threads(threads[lo:hi]):
                    return op(gen, test, process)
        lo = self.ranges[-1][1] if self.ranges else 0
        with with_threads(threads[lo:]):
            return op(self.default, test, process)


def reserve(*args) -> Reserve:
    return Reserve(*args)


class Concat(Generator):
    """First non-None op from the sources, in order
    (``generator.clj:341-350``)."""

    def __init__(self, *sources):
        self.sources = sources

    def op(self, test, process):
        for s in self.sources:
            o = op(s, test, process)
            if o is not None:
                return o
        return None


def concat(*sources) -> Concat:
    return Concat(*sources)


def nemesis(nemesis_gen, client_gen=None):
    """Route the :nemesis process to nemesis_gen, others to client_gen
    (``generator.clj:352-360``)."""
    if client_gen is None:
        return on(lambda t: t == NEMESIS, nemesis_gen)
    return concat(on(lambda t: t == NEMESIS, nemesis_gen),
                  on(lambda t: t != NEMESIS, client_gen))


def clients(client_gen):
    """Only non-nemesis threads (``generator.clj:362-366``)."""
    return on(lambda t: t != NEMESIS, client_gen)


class Await(Generator):
    """Blocks (once) until fn returns, then defers to gen
    (``generator.clj:368-380``)."""

    def __init__(self, fn, gen=None):
        self.fn = fn
        self.gen = gen
        self._lock = threading.Lock()
        self._ready = False

    def op(self, test, process):
        with self._lock:
            if not self._ready:
                self.fn()
                self._ready = True
        return op(self.gen, test, process)


def await_fn(fn, gen=None) -> Await:
    return Await(fn, gen)


class Synchronize(Generator):
    """All routed threads must arrive before any proceeds; synchronizes
    once (``generator.clj:382-396``)."""

    def __init__(self, gen):
        self.gen = gen
        self._lock = threading.Lock()
        self._barrier = None
        self._clear = False

    def op(self, test, process):
        if not self._clear:
            with self._lock:
                if not self._clear and self._barrier is None:
                    n = len(current_threads() or [None])
                    def _clear_fn():
                        self._clear = True
                    self._barrier = threading.Barrier(n, action=_clear_fn)
                b = self._barrier
            if not self._clear and b is not None:
                b.wait()
        return op(self.gen, test, process)


def synchronize(gen) -> Synchronize:
    return Synchronize(gen)


def phases(*generators):
    """Like concat, but all threads finish each phase before the next
    begins (``generator.clj:402-424`` in spirit; barrier via
    :class:`Synchronize`)."""
    return concat(*[synchronize(g) for g in generators])


def then(a, b):
    """b, synchronize, then a — reads well under composition
    (``generator.clj:406-411``)."""
    return concat(b, synchronize(a))


class SingleThreaded(Generator):
    """Drawing an op requires an exclusive lock
    (``generator.clj:413-419``)."""

    def __init__(self, gen):
        self.gen = gen
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            return op(self.gen, test, process)


def singlethreaded(gen) -> SingleThreaded:
    return SingleThreaded(gen)


def barrier(gen):
    """When gen completes, synchronize, then None
    (``generator.clj:421-424``)."""
    return then(void, gen)
