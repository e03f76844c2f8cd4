"""Table-level SUT connection interface + in-memory implementation.

The reference's workloads speak JDBC/SQL to comdb2 (``comdb2/core.clj``,
via ``java.jdbc``). This framework's workloads speak a small
*operation-level* interface instead — insert/select/update/delete inside
serializable transactions — which a real backend adapts to its wire
protocol, and which :class:`MemDB` implements in-memory with strictly
serializable transactions (one global lock) for harness self-tests.
The optional chaos knobs inject failed and indeterminate outcomes to
exercise the harness's fail/info paths.

The counterpart of the JAX package's ``workloads/sqlish.py``: host code;
``MemDB`` draws its chaos outcomes from its own seeded ``random.Random``
as the JAX package's does.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List, Optional


class Rollback(Exception):
    """Raised inside a transaction to abort it (maps to the reference's
    retriable serialization aborts, ``comdb2/core.clj:37-50``)."""


class Indeterminate(Exception):
    """The operation may or may not have applied (timeout/crash) — the
    worker records :info and retires the process."""


def with_txn_retries(fn: Callable[[], Any], attempts: int = 1000) -> Any:
    """Re-run fn until it commits — the reference's ``with-txn-retries``
    loop on retriable aborts (``comdb2/core.clj:52-61``); indeterminate
    outcomes during *setup* are also retried (setup is idempotent)."""
    last: Exception = RuntimeError("no attempts")
    for _ in range(attempts):
        try:
            return fn()
        except (Rollback, Indeterminate) as e:
            last = e
    raise last


class Conn:
    """One client connection. Rows are dicts. ``transaction()`` yields a
    transactional view with serializable isolation."""

    def transaction(self):
        raise NotImplementedError

    # autocommit single-op forms
    def insert(self, table: str, row: dict) -> None:
        with self.transaction() as t:
            t.insert(table, row)

    def select(self, table: str,
               pred: Optional[Callable[[dict], bool]] = None) -> List[dict]:
        with self.transaction() as t:
            return t.select(table, pred)

    def update(self, table: str, assign: dict,
               pred: Optional[Callable[[dict], bool]] = None) -> int:
        with self.transaction() as t:
            return t.update(table, assign, pred)

    def delete(self, table: str,
               pred: Optional[Callable[[dict], bool]] = None) -> int:
        with self.transaction() as t:
            return t.delete(table, pred)

    def close(self) -> None:
        pass


class MemDB:
    """Shared in-memory database: ``{table: [row-dict, ...]}`` guarded
    by one lock — transactions are strictly serializable, like the
    reference's serializable isolation config (``linearizable.lrl``).

    chaos_fail / chaos_unknown: probabilities of raising Rollback /
    Indeterminate at commit time."""

    def __init__(self, chaos_fail: float = 0.0, chaos_unknown: float = 0.0,
                 seed: int = 0):
        self.tables: Dict[str, List[dict]] = {}
        self.lock = threading.RLock()
        self.chaos_fail = chaos_fail
        self.chaos_unknown = chaos_unknown
        self.rng = random.Random(seed)
        self.next_id = 0

    def connect(self) -> "MemConn":
        return MemConn(self)

    def gen_key(self) -> int:
        with self.lock:
            k = self.next_id
            self.next_id += 1
            return k


class _Txn:
    """A serializable transaction over MemDB: holds the global lock,
    buffers writes, applies at commit (so chaos-aborted txns leave no
    trace, and chaos-indeterminate txns may or may not apply)."""

    def __init__(self, db: MemDB):
        self.db = db
        self.writes: List[Callable[[], None]] = []

    # --- ops ---------------------------------------------------------------

    def select(self, table, pred=None):
        rows = self.db.tables.get(table, [])
        return [dict(r) for r in rows if pred is None or pred(r)]

    def insert(self, table, row):
        row = dict(row)
        def apply():
            self.db.tables.setdefault(table, []).append(row)
        self.writes.append(apply)

    def update(self, table, assign, pred=None) -> int:
        matched = [r for r in self.db.tables.get(table, [])
                   if pred is None or pred(r)]
        def apply():
            for r in matched:
                r.update(assign)
        self.writes.append(apply)
        return len(matched)

    def delete(self, table, pred=None) -> int:
        rows = self.db.tables.get(table, [])
        matched = [r for r in rows if pred is None or pred(r)]
        def apply():
            t = self.db.tables.get(table, [])
            for r in matched:
                try:
                    t.remove(r)
                except ValueError:
                    pass
        self.writes.append(apply)
        return len(matched)

    # --- commit protocol ---------------------------------------------------

    def _commit(self):
        db = self.db
        if db.chaos_fail and db.rng.random() < db.chaos_fail:
            raise Rollback("chaos: serialization failure")
        if db.chaos_unknown and db.rng.random() < db.chaos_unknown:
            # apply-or-not with 50/50, then report indeterminate
            if db.rng.random() < 0.5:
                for w in self.writes:
                    w()
            raise Indeterminate("chaos: connection lost at commit")
        for w in self.writes:
            w()


class _TxnCtx:
    def __init__(self, db: MemDB):
        self.db = db

    def __enter__(self) -> _Txn:
        self.db.lock.acquire()
        self.txn = _Txn(self.db)
        return self.txn

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.txn._commit()
        finally:
            self.db.lock.release()
        return False


class MemConn(Conn):
    def __init__(self, db: MemDB):
        self.db = db

    def transaction(self):
        return _TxnCtx(self.db)

    def gen_key(self) -> int:
        return self.db.gen_key()
