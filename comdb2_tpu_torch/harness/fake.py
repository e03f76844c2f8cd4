"""In-memory fake SUT + the noop test map — harness self-tests without
any cluster (``jepsen/tests.clj``).

The counterpart of the JAX package's ``harness/fake.py``. The noop test
map's linearizable checker runs on ``device`` (``None`` means ``cuda``),
resolved when the map is built: on a host without CUDA the default
raises there, before any worker runs.
"""

from __future__ import annotations

import threading
from typing import Any

from ..checker import checkers
from ..models import model as M
from ..utils import resolve_device
from . import client as client_ns
from . import db as db_ns
from . import generator as gen


class AtomDB(db_ns.DB):
    """Wraps shared state as a database (``tests.clj:27-32``)."""

    def __init__(self, state):
        self.state = state

    def setup(self, test, node):
        self.state.reset(None)

    def teardown(self, test, node):
        self.state.reset("done")


class Atom:
    """A compare-and-swap cell (the Clojure atom)."""

    def __init__(self, value: Any = None):
        self.value = value
        self.lock = threading.Lock()

    def reset(self, v):
        with self.lock:
            self.value = v

    def deref(self):
        with self.lock:
            return self.value

    def cas(self, cur, new) -> bool:
        with self.lock:
            if self.value == cur:
                self.value = new
                return True
            return False


class AtomClient(client_ns.Client):
    """A linearizable CAS register over an atom (``tests.clj:34-56``) —
    the fake backend for exercising workers, nemesis, and checkers."""

    def __init__(self, state: Atom):
        self.state = state

    def invoke(self, test, op):
        f = op.get("f")
        if f == "write":
            self.state.reset(op.get("value"))
            return {**op, "type": "ok"}
        if f == "cas":
            cur, new = op.get("value")
            ok = self.state.cas(cur, new)
            return {**op, "type": "ok" if ok else "fail"}
        if f == "read":
            return {**op, "type": "ok", "value": self.state.deref()}
        raise ValueError(f"unknown f {f!r}")


def atom_db(state: Atom) -> AtomDB:
    return AtomDB(state)


def atom_client(state: Atom) -> AtomClient:
    return AtomClient(state)


def noop_test(device=None) -> dict:
    """Boring test stub, basis for real tests (``tests.clj:12-25``).
    Five nodes, noop os/db/client/nemesis, void generator, register
    model, linearizable checker on ``device``."""
    dev = resolve_device(device)
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": "noop",
        "os": db_ns.noop_os,
        "db": db_ns.noop,
        "client": client_ns.noop,
        "nemesis": client_ns.noop_nemesis,
        "generator": gen.void,
        "model": M.register(),
        "checker": checkers.Linearizable(device=dev),
    }
