"""Harness runtime — the test runner.

The semantics of ``jepsen/core.clj``: a test is a map; ``run`` sets up
OS/DB on every node, spawns ``concurrency`` single-threaded worker
processes plus a nemesis, draws ops from the generator, applies them
through clients, records invocations/completions into the history, then
checks the history (``core.clj:324-430``).

The load-bearing rule (``core.clj:178-200``): a worker whose op crashed
or returned ``info`` leaves the invocation pending forever and **retires
its process id** — the thread continues as ``process + concurrency``, so
the checker sees the old op as concurrent with everything after it.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional

from ..checker.checkers import check_safe
from ..ops.op import Op
from . import client as client_ns
from . import db as db_ns
from . import generator as gen

log = logging.getLogger("comdb2_tpu_torch.harness")

NEMESIS = gen.NEMESIS


class History:
    """Thread-safe op log (the reference's history atom)."""

    def __init__(self):
        self._ops: List[Op] = []
        self._lock = threading.Lock()

    def conj(self, op: Op) -> Op:
        with self._lock:
            self._ops.append(op)
        return op

    def snapshot(self) -> List[Op]:
        with self._lock:
            return list(self._ops)


def _op_from_dict(d: dict, process, t: int) -> Op:
    return Op(process=d.get("process", process),
              type=d["type"], f=d.get("f"), value=d.get("value"),
              time=t,
              extra={k: v for k, v in d.items()
                     if k not in ("process", "type", "f", "value", "time")})


def _as_dict(op: Any) -> dict:
    if isinstance(op, Op):
        d = {"type": op.type, "f": op.f, "value": op.value,
             "process": op.process}
        d.update(op.extra or {})
        return d
    return dict(op)


def log_op(op: Op) -> None:
    """Tab-separated op line (``util.clj:241-245``)."""
    log.info("%s\t%s\t%s\t%r", op.process, op.type, op.f, op.value)


class _Clock:
    """Relative wall-clock nanos from test start
    (``util.clj:227-239``)."""

    def __init__(self):
        self.t0 = _time.monotonic_ns()

    def __call__(self) -> int:
        return _time.monotonic_ns() - self.t0


def worker(test: dict, process: int, client: client_ns.Client,
           history: History, clock: _Clock) -> None:
    """One worker loop (``core.clj:141-201``)."""
    g = test["generator"]
    concurrency = test["concurrency"]
    # thread-local binding: each worker OS thread needs its own *threads*
    # (the reference's dynamic binding conveys into futures automatically;
    # threading.local does not)
    with gen.with_threads(_all_threads(test)):
        _worker_loop(test, g, concurrency, process, client, history, clock)


def _all_threads(test: dict) -> list:
    return [NEMESIS] + list(range(test["concurrency"]))


def _worker_loop(test, g, concurrency, process, client, history, clock):
    while True:
        d = gen.op(g, test, process)
        if d is None:
            return
        d = _as_dict(d)
        inv = _op_from_dict(d, process, clock())
        inv = inv.with_(process=process)
        log_op(inv)
        history.conj(inv)
        try:
            comp_d = _as_dict(client.invoke(test, _as_dict(inv)))
            comp = _op_from_dict(comp_d, process, clock())
            assert comp.process == inv.process, "client changed :process"
            assert comp.f == inv.f, "client changed :f"
            log_op(comp)
            history.conj(comp)
            if comp.type in ("ok", "fail"):
                continue            # process is free again
            process += concurrency  # hung: retire the process id
        except Exception as e:       # indeterminate — all bets off
            history.conj(inv.with_(
                type="info", time=clock(),
                extra={**inv.extra, "error": f"indeterminate: {e}"}))
            log.warning("process %s indeterminate: %s", process, e)
            process += concurrency


def nemesis_worker(test: dict, nemesis: client_ns.Client,
                   history: History, clock: _Clock) -> None:
    """The nemesis loop (``core.clj:203-248``): draws from the same
    generator as process :nemesis; ops must be type info; crashes are
    recorded, never fatal."""
    g = test["generator"]
    with gen.with_threads(_all_threads(test)):
        _nemesis_loop(test, g, nemesis, history, clock)


def _nemesis_loop(test, g, nemesis, history, clock):
    while True:
        d = gen.op(g, test, NEMESIS)
        if d is None:
            return
        d = _as_dict(d)
        inv = _op_from_dict(d, NEMESIS, clock()).with_(process=NEMESIS)
        history.conj(inv)
        try:
            log_op(inv)
            assert inv.type == "info", "nemesis ops must be :info"
            comp_d = _as_dict(nemesis.invoke(test, _as_dict(inv)))
            comp = _op_from_dict(comp_d, NEMESIS, clock())
            assert comp.f == inv.f and comp.process == NEMESIS
            assert comp.type == "info", \
                "nemesis completions must stay :info (can't affect the model)"
            log_op(comp)
            history.conj(comp)
        except Exception as e:
            history.conj(inv.with_(time=clock(),
                                   value=f"crashed: {e}"))
            log.warning("nemesis crashed evaluating %s: %s", inv, e)


def _on_nodes(test: dict, f: Callable[[dict, Any], None]) -> None:
    """Apply f(test, node) to every node in parallel, with each thread
    bound to that node's control session so DB/OS implementations can
    call control.exec_/su directly (``control.clj:310-319``)."""
    from .. import control

    if test.get("nodes"):
        control.on_nodes(test, f)


def run_case(test: dict) -> List[Op]:
    """Set up clients + nemesis, run workers to generator exhaustion,
    return the history (``core.clj:270-300``)."""
    history = History()
    clock = test["_clock"]
    concurrency = test["concurrency"]
    nodes = test.get("nodes") or []
    node_cycle = ([None] * concurrency if not nodes
                  else [nodes[i % len(nodes)] for i in range(concurrency)])

    clients = []
    try:
        for node in node_cycle:
            clients.append(test["client"].setup(test, node))
    except Exception:
        for c in clients:
            try:
                c.teardown(test)
            except Exception:
                pass
        raise

    nemesis = test.get("nemesis", client_ns.noop_nemesis).setup(test, None)
    try:
        nem_thread = threading.Thread(
            target=nemesis_worker, args=(test, nemesis, history, clock),
            name="nemesis", daemon=True)
        nem_thread.start()
        workers = []
        for pid, c in enumerate(clients):
            t = threading.Thread(target=worker,
                                 args=(test, pid, c, history, clock),
                                 name=f"worker {pid}", daemon=True)
            t.start()
            workers.append(t)
        for t in workers:
            t.join()
        nem_thread.join()
    finally:
        try:
            nemesis.teardown(test)
        finally:
            for c in clients:
                try:
                    c.teardown(test)
                except Exception:
                    pass
    return history.snapshot()


def snarf_logs(test: dict) -> None:
    """Download each node's SUT log files into the test's store dir
    (``core.clj:92-123``); best-effort."""
    from .. import control
    from . import store

    db = test.get("db")
    if not isinstance(db, db_ns.LogFiles) or not test.get("nodes"):
        return

    def snarf1(test_, node):
        for remote_path in db.log_files(test_, node):
            local = store.path_mkdirs(
                test_, str(node), remote_path.lstrip("/"))
            try:
                control.download(remote_path, local)
            except Exception as e:
                log.info("couldn't download %s from %s: %s",
                         remote_path, node, e)
    try:
        control.on_nodes(test, snarf1)
    except Exception as e:
        log.warning("log snarfing failed: %s", e)


def run(test: dict) -> dict:
    """Run a full test; returns the test map with ``history`` and
    ``results`` (``core.clj:324-430``). Lifecycle: os setup → db cycle →
    clients/nemesis/workers → history → log snarfing → teardown →
    check."""
    from . import store

    test = dict(test)
    test.setdefault("concurrency", max(len(test.get("nodes") or []), 1))
    test.setdefault("start-time", _time.strftime("%Y%m%dT%H%M%S"))
    test["_clock"] = _Clock()

    store.start_logging(test)
    try:
        os_ = test.get("os", db_ns.noop_os)
        db = test.get("db", db_ns.noop)
        _on_nodes(test, os_.setup)
        try:
            _on_nodes(test, lambda t, n: db_ns.cycle(db, t, n))
            if isinstance(db, db_ns.Primary) and test.get("nodes"):
                db.setup_primary(test, test["nodes"][0])
            try:
                threads = [NEMESIS] + list(range(test["concurrency"]))
                with gen.with_threads(threads):
                    history = run_case(test)
                test["history"] = history
            finally:
                # snarf before teardown, success or not — teardown can
                # kill/rotate the very logs needed to debug a failure
                snarf_logs(test)
                _on_nodes(test, db.teardown)
        finally:
            _on_nodes(test, os_.teardown)

        store.save_1(test)
        log.info("Analyzing")
        test["results"] = check_safe(test["checker"], test,
                                     test.get("model"), test["history"])
        log.info("Analysis complete")
        store.save_2(test)
        if test["results"].get("valid?") is True:
            log.info("Everything looks good!")
        else:
            log.info("Analysis invalid!")
        return test
    finally:
        test.pop("_clock", None)
        store.stop_logging(test)
