"""Consistency models.

A model is an immutable, hashable value with a single operation:
``step(model, f, value) -> model' | None`` — apply one operation to the
datatype's abstract state, returning the new state, or ``None`` if the
operation is illegal there (the reference's absorbing ``Inconsistent``
state, ``knossos/model.clj:10-38``).

Models mirror the reference's catalog:

- :func:`register` — ``knossos/model.clj:48-65``
- :func:`cas_register` — ``knossos/model.clj:95-116``
- :func:`cas_register_comdb2` — tuple-valued variant used by the comdb2
  register test (``knossos/model.clj:67-93``; values are ``[id v]``
  pairs produced by ``independent/tuple``)
- :func:`mutex` — ``knossos/model.clj:118-135``
- :func:`multi_register` — ``knossos/model.clj:137-161``
- :func:`set_model`, :func:`unordered_queue`, :func:`fifo_queue` —
  ``jepsen/model.clj:58-105``

Hashability matters: the memoizer (:mod:`comdb2_tpu_torch.models.memo`) interns
model states by value to number the reachable state space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class Model:
    """Base class; subclasses are frozen dataclasses (hence hashable)."""

    def step(self, f: Any, value: Any) -> Optional["Model"]:
        raise NotImplementedError

    def describe(self) -> str:
        return repr(self)


def step(model: Optional[Model], f: Any, value: Any) -> Optional[Model]:
    """Step a model; ``None`` (inconsistent) is absorbing
    (``knossos/model.clj:22-38``)."""
    if model is None:
        return None
    return model.step(f, value)


# --- registers -------------------------------------------------------------

@dataclass(frozen=True)
class Register(Model):
    """A single read/write register. A read of ``None`` (unknown value)
    matches any state, mirroring the reference's nil-read allowance."""

    value: Any = None

    def step(self, f, value):
        if f == "write":
            return Register(value)
        if f == "read":
            if value is None or value == self.value:
                return self
            return None
        return None


@dataclass(frozen=True)
class CASRegister(Model):
    """Read/write/compare-and-set register (``knossos/model.clj:95-116``).
    ``cas`` takes a ``(expected, new)`` pair."""

    value: Any = None

    def step(self, f, value):
        if f == "write":
            return CASRegister(value)
        if f == "cas":
            if value is None:
                # indeterminate cas with unknown arguments can't be modeled
                return None
            expected, new = value
            return CASRegister(new) if self.value == expected else None
        if f == "read":
            if value is None or value == self.value:
                return self
            return None
        return None


@dataclass(frozen=True)
class CASRegisterComdb2(Model):
    """CAS register whose op values are ``(key, v)`` tuples as produced by
    ``independent/tuple`` (``knossos/model.clj:67-93``): the key is
    ignored, the payload is the second element. Only tagged
    :class:`~comdb2_tpu_torch.ops.kv.KVTuple` values (or plain 2-sequences
    from EDN histories whose second element carries the payload) are
    unwrapped — a bare ``(expected, new)`` cas pair must NOT be."""

    value: Any = None

    def _unwrap(self, value):
        from ..ops.kv import KVTuple

        # only explicitly-tagged keyed values unwrap: a bare 2-tuple is
        # a cas (expected, new) pair, not a key wrapper — EDN histories
        # with [k v] vectors opt in via independent.wrap_keyed_history
        if isinstance(value, KVTuple):
            return value.value
        return value

    def step(self, f, value):
        v = self._unwrap(value)
        if f == "write":
            return CASRegisterComdb2(v)
        if f == "cas":
            if v is None:
                return None
            expected, new = v
            return CASRegisterComdb2(new) if self.value == expected else None
        if f == "read":
            if v is None or v == self.value:
                return self
            return None
        return None


# --- mutex -----------------------------------------------------------------

@dataclass(frozen=True)
class Mutex(Model):
    """acquire/release lock (``knossos/model.clj:118-135``)."""

    locked: bool = False

    def step(self, f, value):
        if f == "acquire":
            return Mutex(True) if not self.locked else None
        if f == "release":
            return Mutex(False) if self.locked else None
        return None


# --- multi-register (transactional) ---------------------------------------

@dataclass(frozen=True)
class MultiRegister(Model):
    """A map of registers stepped by transactions: the op value is a
    sequence of ``[f k v]`` micro-ops applied atomically
    (``knossos/model.clj:137-161``). State is a sorted tuple of (k, v)."""

    entries: Tuple[Tuple[Any, Any], ...] = ()

    def _get(self, k):
        for kk, vv in self.entries:
            if kk == k:
                return vv
        return None

    def _set(self, k, v):
        items = dict(self.entries)
        items[k] = v
        return tuple(sorted(items.items(), key=repr))

    def step(self, f, value):
        if f not in ("txn", "read", "write"):
            return None
        if value is None:
            return self
        cur = self
        for micro in value:
            mf, k, v = micro
            if mf == "read":
                if v is not None and cur._get(k) != v:
                    return None
            elif mf == "write":
                cur = MultiRegister(cur._set(k, v))
            else:
                return None
        return cur


# --- set -------------------------------------------------------------------

@dataclass(frozen=True)
class GSet(Model):
    """A grow-only set: ``add v``; ``read`` returns the full set
    (``jepsen/model.clj:58-75``). State is a frozenset."""

    elements: frozenset = frozenset()

    def step(self, f, value):
        if f == "add":
            return GSet(self.elements | {value})
        if f == "read":
            if value is None:
                return self
            want = frozenset(value) if not isinstance(value, frozenset) \
                else value
            return self if want == self.elements else None
        return None


# --- queues ----------------------------------------------------------------

@dataclass(frozen=True)
class UnorderedQueue(Model):
    """enqueue/dequeue where dequeue may return any enqueued element
    (``jepsen/model.clj:77-91``). State is a sorted tuple (multiset)."""

    elements: Tuple = ()

    def step(self, f, value):
        if f == "enqueue":
            return UnorderedQueue(tuple(sorted(
                self.elements + (value,), key=repr)))
        if f == "dequeue":
            if value in self.elements:
                items = list(self.elements)
                items.remove(value)
                return UnorderedQueue(tuple(items))
            return None
        return None


@dataclass(frozen=True)
class FIFOQueue(Model):
    """Strict FIFO queue (``jepsen/model.clj:93-105``)."""

    elements: Tuple = ()

    def step(self, f, value):
        if f == "enqueue":
            return FIFOQueue(self.elements + (value,))
        if f == "dequeue":
            if self.elements and self.elements[0] == value:
                return FIFOQueue(self.elements[1:])
            return None
        return None


# --- constructors (reference-parity names) ---------------------------------

def register(value=None) -> Register:
    return Register(value)


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


def cas_register_comdb2(value=None) -> CASRegisterComdb2:
    return CASRegisterComdb2(value)


def mutex() -> Mutex:
    return Mutex(False)


def multi_register(entries=None) -> MultiRegister:
    if entries:
        return MultiRegister(tuple(sorted(entries.items(), key=repr)))
    return MultiRegister()


def set_model() -> GSet:
    return GSet()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


MODELS = {
    "register": register,
    "cas-register": cas_register,
    "cas-register-comdb2": cas_register_comdb2,
    "mutex": mutex,
    "multi-register": multi_register,
    "set": set_model,
    "unordered-queue": unordered_queue,
    "fifo-queue": fifo_queue,
}
