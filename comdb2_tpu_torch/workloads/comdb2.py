"""The comdb2 test suite — every workload from ``comdb2/core.clj``,
re-built over the table-level connection interface
(:mod:`comdb2_tpu_torch.workloads.sqlish`) so they run against the in-memory
serializable backend today and any real SUT adapter tomorrow.

Workloads: cas-register (``core.clj:358-479``), bank (``:71-177``),
sets (``:223-271``), dirty-reads (``:320-355``), plus the Adya G2
anti-dependency workload (``jepsen/adya.clj``). Testers mirror
``register-tester[-nemesis]``, ``bank-test``, ``sets-test``,
``dirty-reads-tester`` (``core.clj:567-613,274-316,252-271,550-564``).

The counterpart of the JAX package's ``workloads/comdb2.py``. Every
tester takes ``device`` (``None`` means ``cuda``) and resolves it when
it builds the test map, so on a host without CUDA the default raises
there, before any worker runs; the linearizable checkers it builds run
on that device (the per-key batch through the segment-search kernel's
stream mode, a lone or failing key through its single-history mode).
The bank, sets, dirty-reads and G2 testers compose the JAX package's
host checkers, which touch no device.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional

from ..checker import checkers as C
from ..checker import independent as I
from ..checker.workloads import bank_checker, dirty_reads_checker, g2_checker
from ..harness import client as client_ns
from ..harness import db as db_ns
from ..harness import fake
from ..harness import generator as gen
from ..models import model as M
from ..utils import resolve_device
from ..report import perf_checker, Timeline
from .sqlish import (Conn, Indeterminate, MemDB, Rollback,
                     with_txn_retries)


def _invoke_guard(fn):
    """Map backend outcomes to op completions: Rollback → fail,
    Indeterminate → info (the worker then retires the process)."""
    def wrapped(self, test, op):
        try:
            return fn(self, test, op)
        except Rollback:
            return {**op, "type": "fail"}
        except Indeterminate as e:
            return {**op, "type": "info", "error": str(e)}
    return wrapped


# --- cas register (core.clj:358-479) ---------------------------------------

class CasRegisterClient(client_ns.Client):
    """Read/write/cas on a one-row ``register(id,val,uid)`` table.
    Values are ``(key, v)`` tuples from the independent generator; reads
    return ``(1, current)``; a write that updates zero rows inserts; cas
    updates ``where id=k and val=expected`` and fails on zero rows."""

    def __init__(self, connect: Callable[[], Conn]):
        self.connect = connect
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = CasRegisterClient(self.connect)
        c.conn = self.connect()
        # fresh table per run (core.clj:362-366 deletes register rows)
        with_txn_retries(lambda: c.conn.delete("register"))
        return c

    @_invoke_guard
    def invoke(self, test, op):
        f = op["f"]
        k, v = op["value"] if op["value"] is not None else (1, None)
        uid = random.randrange(100000) * 1000
        with self.conn.transaction() as t:
            rows = t.select("register", lambda r: r["id"] == k)
            cur = rows[0]["val"] if rows else None
            if f == "read":
                return {**op, "type": "ok", "value": I.tuple_(k, cur)}
            if f == "write":
                if rows:
                    n = t.update("register", {"val": v, "uid": uid},
                                 lambda r: r["id"] == k)
                else:
                    t.insert("register", {"id": k, "val": v, "uid": uid})
                    n = 1
                if n == 0:
                    return {**op, "type": "fail"}
                return {**op, "type": "ok"}
            if f == "cas":
                expected, new = v
                n = t.update("register", {"val": new, "uid": uid},
                             lambda r: r["id"] == k and r["val"] == expected)
                return {**op, "type": "ok" if n == 1 else "fail"}
        raise ValueError(f"unknown f {f!r}")


def r(test=None, process=None):
    return {"type": "invoke", "f": "read", "value": I.tuple_(1, None)}


def w(test=None, process=None):
    return {"type": "invoke", "f": "write",
            "value": I.tuple_(1, random.randrange(5))}


def cas(test=None, process=None):
    return {"type": "invoke", "f": "cas",
            "value": I.tuple_(1, (random.randrange(5),
                                  random.randrange(5)))}


# --- bank (core.clj:71-177) -------------------------------------------------

class BankClient(client_ns.Client):
    """Transfers between n accounts; total balance is invariant."""

    def __init__(self, connect: Callable[[], Conn], n: int,
                 starting_balance: int = 10):
        self.connect = connect
        self.n = n
        self.starting_balance = starting_balance
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = BankClient(self.connect, self.n, self.starting_balance)
        c.conn = self.connect()

        def create_accounts():
            with c.conn.transaction() as t:
                existing = {row["id"] for row in t.select("accounts")}
                for i in range(self.n):
                    if i not in existing:
                        t.insert("accounts",
                                 {"id": i,
                                  "balance": self.starting_balance})
        with_txn_retries(create_accounts)
        return c

    @_invoke_guard
    def invoke(self, test, op):
        with self.conn.transaction() as t:
            if op["f"] == "read":
                rows = t.select("accounts")
                rows.sort(key=lambda r: r["id"])
                return {**op, "type": "ok",
                        "value": tuple(r["balance"] for r in rows)}
            if op["f"] == "transfer":
                v = op["value"]
                frm, to, amount = v["from"], v["to"], v["amount"]
                b1 = t.select("accounts",
                              lambda r: r["id"] == frm)[0]["balance"] - amount
                b2 = t.select("accounts",
                              lambda r: r["id"] == to)[0]["balance"] + amount
                if b1 < 0:
                    return {**op, "type": "fail",
                            "value": ("negative", frm, b1)}
                if b2 < 0:
                    return {**op, "type": "fail",
                            "value": ("negative", to, b2)}
                t.update("accounts", {"balance": b1},
                         lambda rr: rr["id"] == frm)
                t.update("accounts", {"balance": b2},
                         lambda rr: rr["id"] == to)
                return {**op, "type": "ok"}
        raise ValueError(f"unknown f {op['f']!r}")


def bank_read(test=None, process=None):
    return {"type": "invoke", "f": "read", "value": None}


def bank_transfer(test, process):
    n = test["_bank_n"]
    return {"type": "invoke", "f": "transfer",
            "value": {"from": random.randrange(n),
                      "to": random.randrange(n),
                      "amount": random.randrange(5)}}


def bank_diff_transfer(test, process):
    """Transfers between *different* accounts (core.clj:146-150)."""
    while True:
        op = bank_transfer(test, process)
        if op["value"]["from"] != op["value"]["to"]:
            return op


# --- sets (core.clj:223-271) ------------------------------------------------

class SetClient(client_ns.Client):
    """add: insert a unique row into ``jepsen(id,value)``; read: the
    sorted set of values."""

    def __init__(self, connect: Callable[[], Conn]):
        self.connect = connect
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = SetClient(self.connect)
        c.conn = self.connect()
        return c

    @_invoke_guard
    def invoke(self, test, op):
        with self.conn.transaction() as t:
            if op["f"] == "add":
                key = getattr(self.conn, "gen_key", lambda: random.getrandbits(62))()
                t.insert("jepsen", {"id": key, "value": op["value"]})
                return {**op, "type": "ok"}
            if op["f"] == "read":
                vals = frozenset(row["value"] for row in t.select("jepsen"))
                return {**op, "type": "ok", "value": vals}
        raise ValueError(f"unknown f {op['f']!r}")


# --- dirty reads (core.clj:320-355) -----------------------------------------

class DirtyReadsClient(client_ns.Client):
    """write x: update every row of ``dirty`` to x (in random order);
    read: all x values (skipping the -1 initializer rows). A failed
    write whose x becomes visible is a dirty read."""

    def __init__(self, connect: Callable[[], Conn], n: int):
        self.connect = connect
        self.n = n
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = DirtyReadsClient(self.connect, self.n)
        c.conn = self.connect()

        def create_rows():
            with c.conn.transaction() as t:
                existing = {row["id"] for row in t.select("dirty")}
                for i in range(self.n):
                    if i not in existing:
                        t.insert("dirty", {"id": i, "x": -1})
        with_txn_retries(create_rows)
        return c

    @_invoke_guard
    def invoke(self, test, op):
        with self.conn.transaction() as t:
            if op["f"] == "read":
                rows = t.select("dirty", lambda r: r["x"] != -1)
                return {**op, "type": "ok",
                        "value": tuple(r["x"] for r in rows)}
            if op["f"] == "write":
                x = op["value"]
                order = list(range(self.n))
                random.shuffle(order)
                for i in order:
                    t.select("dirty", lambda r, i=i: r["id"] == i)
                for i in order:
                    t.update("dirty", {"x": x},
                             lambda r, i=i: r["id"] == i)
                return {**op, "type": "ok"}
        raise ValueError(f"unknown f {op['f']!r}")


def dirty_reads_read(test=None, process=None):
    return {"type": "invoke", "f": "read", "value": None}


class _DirtyWrites(gen.Generator):
    """Writes of consecutive integers (core.clj:527-534)."""

    def __init__(self):
        self._i = -1
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            self._i += 1
            v = self._i
        return {"type": "invoke", "f": "write", "value": v}


# --- adya G2 (jepsen/adya.clj) ----------------------------------------------

class G2Client(client_ns.Client):
    """Anti-dependency-cycle workload: in one txn, predicate-read tables
    a and b for the key; if both empty, insert the present id into its
    table. At most one insert may commit per key (``adya.clj:12-55``)."""

    def __init__(self, connect: Callable[[], Conn]):
        self.connect = connect
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = G2Client(self.connect)
        c.conn = self.connect()
        return c

    @_invoke_guard
    def invoke(self, test, op):
        k, ids = op["value"]
        a_id, b_id = ids
        with self.conn.transaction() as t:
            a = t.select("a", lambda row: row["key"] == k
                         and row["value"] % 3 == 0)
            b = t.select("b", lambda row: row["key"] == k
                         and row["value"] % 3 == 0)
            if a or b:
                return {**op, "type": "fail"}
            if a_id is not None:
                t.insert("a", {"id": a_id, "key": k, "value": 30})
            else:
                t.insert("b", {"id": b_id, "key": k, "value": 30})
        return {**op, "type": "ok"}


class ListAppendClient(client_ns.Client):
    """Elle's list-append workload over the table interface: a txn op's
    value is a sequence of micro-ops ``("append", k, v)`` /
    ``("r", k, None)``; appends insert ``{key, v}`` rows into the
    ``la`` table, reads select the key's rows in insertion order (the
    whole list — version order is recoverable). Reads within one txn
    see the txn's OWN earlier appends (buffered-write fixup) so the
    history honors the standard list-append semantics."""

    def __init__(self, connect: Callable[[], Conn]):
        self.connect = connect
        self.conn: Optional[Conn] = None

    def setup(self, test, node):
        c = ListAppendClient(self.connect)
        c.conn = self.connect()
        return c

    @_invoke_guard
    def invoke(self, test, op):
        done = []
        own: dict = {}
        with self.conn.transaction() as t:
            for f, k, v in op["value"]:
                if f == "append":
                    t.insert("la", {"key": k, "v": v})
                    own.setdefault(k, []).append(v)
                    done.append(("append", k, v))
                else:
                    rows = t.select("la", lambda r, k=k: r["key"] == k)
                    vals = [r["v"] for r in rows] + own.get(k, [])
                    done.append(("r", k, tuple(vals)))
        return {**op, "type": "ok", "value": tuple(done)}


def list_append_gen(n_keys: int = 3, max_micro: int = 3):
    """Txn invocations with unique per-key append values (the Elle
    precondition) — thread-safe counters shared by all workers."""
    counters = [0] * n_keys
    lock = threading.Lock()

    def next_val(k):
        with lock:
            counters[k] += 1
            return counters[k]

    def gen_op(test=None, process=None):
        mops = []
        for _ in range(random.randint(1, max_micro)):
            k = random.randrange(n_keys)
            if random.random() < 0.5:
                mops.append(("append", k, next_val(k)))
            else:
                mops.append(("r", k, None))
        return {"type": "invoke", "f": "txn", "value": tuple(mops)}

    return gen_op


def g2_gen():
    """Concurrent unique keys, two inserts per key with globally unique
    ids, 2 threads per key — the reference's shape exactly
    (``adya.clj:14-55``: ``independent/concurrent-generator 2 (range)``
    over a two-op seq)."""
    import itertools

    from ..harness import independent_gen as IG

    ids = itertools.count(1)
    lock = threading.Lock()

    def next_id():
        with lock:
            return next(ids)

    def fgen(k):
        return gen.seq([
            lambda t, p: {"type": "invoke", "f": "insert",
                          "value": (None, next_id())},
            lambda t, p: {"type": "invoke", "f": "insert",
                          "value": (next_id(), None)},
        ])

    return IG.concurrent_generator(2, itertools.count(1), fgen)


# --- testers (core.clj:195-208,567-613) ------------------------------------

def with_nemesis(client_gen):
    """10 s on / 10 s off nemesis cycle around a client generator
    (``core.clj:179-193``)."""
    import itertools

    return gen.phases(
        gen.phases(
            gen.nemesis(
                gen.seq(itertools.cycle(
                    [gen.sleep(0), {"type": "info", "f": "start"},
                     gen.sleep(10), {"type": "info", "f": "stop"}])),
                client_gen),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5)))


def basic_test(opts: dict, device=None) -> dict:
    """noop-test + 5 nodes + overrides (``core.clj:195-208``)."""
    t = fake.noop_test(device)
    t.update({"nodes": ["m1", "m2", "m3", "m4", "m5"],
              "name": "comdb2"})
    t.update(opts)
    return t


def _default_connect() -> Callable[[], Conn]:
    db = MemDB()
    return db.connect


def register_tester(opts: Optional[dict] = None,
                    connect: Optional[Callable[[], Conn]] = None,
                    time_limit: float = 10.0,
                    quiesce: float = 0.0, device=None) -> dict:
    """The register test (``core.clj:567-589``): concurrency 10, mix
    [w cas cas r] staggered 1/10 s, independent-keyed linearizable +
    perf + timeline checkers."""
    dev = resolve_device(device)
    connect = connect or _default_connect()
    t = basic_test({
        "name": "register",
        "client": CasRegisterClient(connect),
        "concurrency": 10,
        # the independent checker unwraps (k, v) tuples per key, so the
        # per-key model is a plain cas-register (the comdb2 tuple
        # variant is for un-partitioned keyed histories)
        "model": M.cas_register(),
        "generator": gen.phases(
            gen.time_limit(time_limit,
                           gen.stagger(0.1, gen.clients(
                               gen.mix([w, cas, cas, r])))),
            gen.log("waiting for quiescence"),
            gen.sleep(quiesce)),
        "checker": C.compose({
            "perf": perf_checker(),
            "timeline": Timeline(),
            "linearizable": I.checker(C.Linearizable(device=dev)),
        }),
    }, device=dev)
    t.update(opts or {})
    return t


def register_tester_nemesis(opts: Optional[dict] = None,
                            connect: Optional[Callable[[], Conn]] = None,
                            time_limit: float = 300.0,
                            device=None) -> dict:
    """register + partition nemesis (``core.clj:591-613``). As in the
    JAX package, its generator is not bounded by ``time_limit`` (the
    nemesis cycle wraps an endless client mix): callers bound it."""
    from ..harness import nemesis as N

    t = register_tester(opts={}, connect=connect, time_limit=time_limit,
                        device=device)
    t["name"] = "register-nemesis"
    t["nemesis"] = N.partition_random_halves()
    t["generator"] = gen.phases(
        with_nemesis(gen.stagger(0.1, gen.clients(
            gen.mix([w, cas, cas, r])))),
        gen.log("waiting for quiescence"),
        gen.sleep(10))
    t.update(opts or {})
    return t


def bank_test(opts: Optional[dict] = None,
              connect: Optional[Callable[[], Conn]] = None,
              n: int = 5, starting_balance: int = 10,
              time_limit: float = 100.0, device=None) -> dict:
    """(``core.clj:274-316``)"""
    connect = connect or _default_connect()
    t = basic_test({
        "name": "bank",
        "client": BankClient(connect, n, starting_balance),
        "concurrency": 10,
        "_bank_n": n,
        "model": {"n": n, "total": n * starting_balance},
        "generator": gen.clients(
            gen.time_limit(time_limit,
                           gen.stagger(0.05,
                                       gen.mix([bank_read,
                                                bank_diff_transfer])))),
        "checker": C.compose({"perf": perf_checker(),
                              "bank": bank_checker}),
    }, device=device)
    t.update(opts or {})
    return t


def sets_test(opts: Optional[dict] = None,
              connect: Optional[Callable[[], Conn]] = None,
              adds: int = 100, device=None) -> dict:
    """Unique adds then a final read (``core.clj:252-271``)."""
    connect = connect or _default_connect()
    counter = iter(range(1 << 60))

    def add(test=None, process=None):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    t = basic_test({
        "name": "set",
        "client": SetClient(connect),
        "concurrency": 10,
        "generator": gen.clients(gen.phases(
            gen.limit(adds, add),
            gen.once({"type": "invoke", "f": "read", "value": None}))),
        "checker": C.set_checker,
    }, device=device)
    t.update(opts or {})
    return t


def dirty_reads_tester(opts: Optional[dict] = None,
                       connect: Optional[Callable[[], Conn]] = None,
                       n: int = 4, time_limit: float = 10.0,
                       device=None) -> dict:
    """(``core.clj:550-564``)"""
    connect = connect or _default_connect()
    t = basic_test({
        "name": "dirty-reads",
        "client": DirtyReadsClient(connect, n),
        "concurrency": 4,
        "generator": gen.clients(
            gen.time_limit(time_limit,
                           gen.mix([dirty_reads_read, _DirtyWrites()]))),
        "checker": C.compose({"dirty-reads": dirty_reads_checker,
                              "perf": perf_checker()}),
    }, device=device)
    t.update(opts or {})
    return t


def g2_test(opts: Optional[dict] = None,
            connect: Optional[Callable[[], Conn]] = None,
            ops: int = 100, device=None) -> dict:
    """Adya G2 (``adya.clj``)."""
    connect = connect or _default_connect()
    t = basic_test({
        "name": "g2",
        "client": G2Client(connect),
        "concurrency": 10,
        "generator": gen.clients(gen.limit(ops, g2_gen())),
        "checker": g2_checker,
    }, device=device)
    t.update(opts or {})
    return t
