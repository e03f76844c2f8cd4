"""Independent-key generators — lift single-key generators to keyed maps
(``jepsen/independent.clj:30-225``).

``sequential_generator``: one key at a time; when a key's generator is
exhausted, move to the next key.

``concurrent_generator``: n threads per key; the thread pool splits into
``thread_count // n`` groups, each group running one key's generator
with a rebound thread set (so per-key barriers work); when a group's
generator is exhausted, it takes the next key.

The counterpart of the JAX package's ``harness/independent_gen.py``:
host code, the same op streams.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from ..ops.kv import tuple_
from . import generator as gen


class SequentialGenerator(gen.Generator):
    """(``independent.clj:30-62``) — keys in order, values wrapped as
    (k, v) tuples."""

    def __init__(self, keys: Iterable, fgen: Callable[[Any], Any]):
        self._keys: Iterator = iter(keys)
        self.fgen = fgen
        self._lock = threading.Lock()
        self._cur_key = None
        self._cur_gen = None
        self._done = False
        self._advance()

    def _advance(self) -> None:
        try:
            self._cur_key = next(self._keys)
            self._cur_gen = self.fgen(self._cur_key)
        except StopIteration:
            self._done = True
            self._cur_gen = None

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                k, g = self._cur_key, self._cur_gen
            o = gen.op(g, test, process)
            if o is not None:
                return {**o, "value": tuple_(k, o.get("value"))}
            with self._lock:
                if self._cur_key is k:      # nobody advanced before us
                    self._advance()


def sequential_generator(keys, fgen) -> SequentialGenerator:
    return SequentialGenerator(keys, fgen)


class ConcurrentGenerator(gen.Generator):
    """(``independent.clj:64-225``) — n threads per key, concurrent
    groups. Initializes lazily on the first call, asserting the visible
    thread set divides into groups of n; each group's subtree sees only
    its own threads (`*threads*` rebinding), so per-key synchronize
    barriers work."""

    def __init__(self, n: int, keys: Iterable,
                 fgen: Callable[[Any], Any]):
        assert n > 0 and int(n) == n
        self.n = int(n)
        self._keys: Iterator = iter(keys)
        self.fgen = fgen
        self._lock = threading.Lock()
        self._init = False
        self._threads: Optional[list] = None
        self._group_threads: Optional[list] = None
        self._active: Optional[list] = None   # per group: (k, gen) | None

    def _next_key(self):
        try:
            k = next(self._keys)
            return (k, self.fgen(k))
        except StopIteration:
            return None

    def _initialize(self, test) -> None:
        threads = [t for t in (gen.current_threads() or
                               range(test["concurrency"]))
                   if isinstance(t, int)]
        count = len(threads)
        assert count == test["concurrency"], (
            f"expected concurrency ({test['concurrency']}) integer "
            f"threads, got {count}")
        group_count = count // self.n
        assert group_count * self.n == count, (
            f"concurrent-generator has {count} threads but needs a "
            f"multiple of {self.n} to run {group_count} keys with "
            f"{self.n} threads apiece; adjust :concurrency")
        self._threads = threads
        self._group_threads = [threads[i * self.n:(i + 1) * self.n]
                               for i in range(group_count)]
        self._active = [self._next_key() for _ in range(group_count)]
        self._init = True

    def op(self, test, process):
        with self._lock:
            if not self._init:
                self._initialize(test)
        thread = gen.process_to_thread(test, process)
        assert isinstance(thread, int), (
            "only integer worker threads can draw from "
            f"concurrent-generator, not {thread!r}")
        group = self._threads.index(thread) // self.n
        while True:
            with self._lock:
                pair = self._active[group]
            if pair is None:
                return None
            k, g = pair
            with gen.with_threads(self._group_threads[group]):
                o = gen.op(g, test, process)
            if o is not None:
                return {**o, "value": tuple_(k, o.get("value"))}
            with self._lock:
                if self._active[group] is pair:   # don't race the swap
                    self._active[group] = self._next_key()


def concurrent_generator(n: int, keys, fgen) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, fgen)
