"""Lifecycle/ordering checker of the port's fleet plane — the
counterpart of the JAX package's ``analysis/lifecycle.py``, its six
rules as written.

The rules run over the port's ``service/daemon.py``,
``service/supervisor.py``, ``service/client.py``,
``harness/killcluster.py``, ``workloads/tcp.py`` and ``control/`` (and
over every other file of the scan; only those hold the protocols):

- ``publish-before-ready`` — the pmux registration must precede the
  ready line: "ready" means DISCOVERABLE.
- ``deregister-before-close`` — a withdrawing daemon deregisters (and
  bumps the ring epoch) BEFORE closing its listener.
- ``log-after-success`` — checkpoint/replay logs append only AFTER the
  guarded operation succeeded.
- ``release-in-finally`` — in cleanup-named functions, pin/park/ring
  releases sit in a ``try/finally``.
- ``fresh-deadline-timestamp`` — TTL/blacklist/park deadlines are
  stamped where they are stored, never from a loop-entry timestamp.
- ``wait-after-kill`` — every ``.kill()``/``.terminate()`` is
  followed by ``.wait()`` on the SAME process (no init reaper: an
  unwaited child stays a zombie).

All rules are AST/per-function (statement order by line number, nested
``def``/``lambda`` bodies excluded — deferred closures run at a
different time and are checked as their own functions). Tests are
exempt (they drive lifecycles out of order on purpose); seeded
fixtures under tests/fixtures/ are not.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from . import Finding, suppressed

#: function-name parts marking a cleanup path (release-in-finally)
CLEANUP_PARTS = ("close", "shutdown", "stop", "retire", "cleanup",
                 "__exit__")

#: callee names that release a pin/park/ring resource
RELEASE_NAMES = {"_unpin", "unpin", "release", "unpark"}

#: attribute names holding replay/checkpoint logs (log-after-success)
LOG_ATTRS = {"_log", "_deltas"}

#: logger-ish trailing callee names that may follow a log append
#: without implying more guarded work
_BENIGN_AFTER_LOG = {"info", "debug", "warning", "error", "exception",
                     "append"}

#: clock callables whose result must not anchor a later-stored deadline
CLOCK_FNS = {"monotonic", "_monotonic", "time", "perf_counter"}

#: identifier parts marking a TTL/blacklist/park deadline store
DEADLINE_PARTS = ("avoid", "deadline", "blacklist", "not_before",
                  "until", "expires", "park")

#: identifier parts naming a listener socket (deregister-before-close)
LISTENER_PARTS = ("lsock", "listen")

#: callee-name parts for pmux registration / withdrawal
PUBLISH_PARTS = ("publish",)
WITHDRAW_PARTS = ("withdraw", "deregister")


def _callee(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _chain(node: ast.AST) -> List[str]:
    """Identifier chain of a Name/Attribute/Subscript expression
    (``self._avoid[name]`` -> ``["self", "_avoid"]``)."""
    out: List[str] = []

    def walk(n):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            walk(n.value)
            out.append(n.attr)
        elif isinstance(n, ast.Subscript):
            walk(n.value)
        elif isinstance(n, ast.Call):
            walk(n.func)

    walk(node)
    return out


def _direct(fn: ast.AST) -> List[ast.AST]:
    """All descendant nodes of ``fn`` EXCLUDING nested function/lambda
    subtrees — a deferred closure runs at a different lifecycle point
    and is analyzed as its own function."""
    out: List[ast.AST] = []

    def walk(node):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
                continue
            out.append(ch)
            walk(ch)

    walk(fn)
    return out


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _finally_nodes(fn: ast.AST) -> set:
    """id()s of every node under some ``try``'s ``finally`` block."""
    out: set = set()
    for node in _direct(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                out.add(id(stmt))
                for sub in ast.walk(stmt):
                    out.add(id(sub))
    return out


def _ready_sink_line(fn: ast.AST) -> Optional[int]:
    """Line of the first print/write/sendall call carrying a "ready"
    payload (the daemon ready line), if any."""
    best: Optional[int] = None
    for node in _direct(fn):
        if not isinstance(node, ast.Call):
            continue
        if _callee(node) not in ("print", "write", "sendall"):
            continue
        ready = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str) \
                    and "ready" in sub.value:
                ready = True
            if isinstance(sub, ast.Dict):
                for k in sub.keys:
                    if isinstance(k, ast.Constant) and k.value == "ready":
                        ready = True
        if ready and (best is None or node.lineno < best):
            best = node.lineno
    return best


def _check_publish_before_ready(fn, raw, path):
    publish = [n.lineno for n in _direct(fn)
               if isinstance(n, ast.Call)
               and any(p in _callee(n) for p in PUBLISH_PARTS)]
    if not publish:
        return
    ready = _ready_sink_line(fn)
    if ready is not None and ready < min(publish):
        raw.append(Finding(
            "publish-before-ready", path, ready,
            "ready line emitted before the pmux publish — 'ready' "
            "must mean DISCOVERABLE; a supervisor that routes on this "
            "line reaches a daemon the ring cannot see"))


def _check_deregister_before_close(fn, raw, path):
    withdraws = [n.lineno for n in _direct(fn)
                 if isinstance(n, ast.Call)
                 and any(p in _callee(n) for p in WITHDRAW_PARTS)]
    if not withdraws:
        return
    for n in _direct(fn):
        if isinstance(n, ast.Call) and _callee(n) == "close" \
                and isinstance(n.func, ast.Attribute):
            chain = _chain(n.func.value)
            if any(any(p in part for p in LISTENER_PARTS)
                   for part in chain) and n.lineno < min(withdraws):
                raw.append(Finding(
                    "deregister-before-close", path, n.lineno,
                    "listener closed before the pmux withdraw/epoch "
                    "bump — clients re-route on the epoch bump; a "
                    "listener closed first turns every in-flight ring "
                    "walk into a connect error against a node the "
                    "ring still advertises"))


def _check_log_after_success(fn, raw, path):
    appends: List[Tuple[int, str]] = []
    for n in _direct(fn):
        if isinstance(n, ast.Call) and _callee(n) == "append" \
                and isinstance(n.func, ast.Attribute):
            recv = n.func.value
            if isinstance(recv, ast.Attribute) \
                    and (recv.attr in LOG_ATTRS
                         or recv.attr.endswith("_log")):
                appends.append((n.lineno, recv.attr))
    if not appends:
        return
    for ln, attr in appends:
        later = [n for n in _direct(fn)
                 if isinstance(n, ast.Call) and n.lineno > ln
                 and _callee(n) not in _BENIGN_AFTER_LOG]
        if later:
            raw.append(Finding(
                "log-after-success", path, ln,
                f"append to the replay log '{attr}' before the "
                "guarded work finished (calls follow at line "
                f"{later[0].lineno}) — log only AFTER success, or a "
                "failed call replays into every restore/failover"))


def _check_release_in_finally(fn, raw, path):
    name = fn.name.lower()
    if not any(p in name for p in CLEANUP_PARTS):
        return
    fin = _finally_nodes(fn)
    calls = [n for n in _direct(fn) if isinstance(n, ast.Call)]
    for n in calls:
        if _callee(n) not in RELEASE_NAMES or id(n) in fin:
            continue
        # risk only exists when fallible work precedes the release
        if any(c.lineno < n.lineno for c in calls
               if _callee(c) not in RELEASE_NAMES):
            raw.append(Finding(
                "release-in-finally", path, n.lineno,
                f"{_callee(n)}() on a cleanup path outside "
                "try/finally — an exception in the preceding calls "
                "leaks the pin/session forever (failover never "
                "re-routes, eviction never fires)"))


def _check_fresh_deadline(fn, raw, path):
    # clock-derived names: `now = monotonic()` and friends
    clock_assigns = {}
    for n in _direct(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _callee(n.value) in CLOCK_FNS:
            for tgt in n.targets:
                if isinstance(tgt, ast.Name):
                    clock_assigns[tgt.id] = n.lineno
    if not clock_assigns:
        return
    loops = [n for n in _direct(fn) if isinstance(n, (ast.For,
                                                      ast.While))]
    for n in _direct(fn):
        if not isinstance(n, ast.Assign) \
                or not isinstance(n.value, ast.BinOp) \
                or not isinstance(n.value.op, ast.Add):
            continue
        tgt_parts = [p.lower() for t in n.targets for p in _chain(t)]
        if not any(any(d in part for d in DEADLINE_PARTS)
                   for part in tgt_parts):
            continue
        stale = [name for name in
                 {s.id for s in ast.walk(n.value)
                  if isinstance(s, ast.Name)} & set(clock_assigns)
                 if any(clock_assigns[name] < lp.lineno <= n.lineno
                        for lp in loops)]
        if stale:
            raw.append(Finding(
                "fresh-deadline-timestamp", path, n.lineno,
                f"deadline stored from loop-entry timestamp "
                f"'{stale[0]}' (taken at line "
                f"{clock_assigns[stale[0]]}) — a hung connect burns "
                "its whole timeout before raising, so this deadline "
                "is already expired when written; call the clock at "
                "the store site"))


def _check_wait_after_kill(fn, raw, path):
    calls = [n for n in _direct(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)]
    waits = [(ast.unparse(n.func.value), n.lineno) for n in calls
             if n.func.attr == "wait"]
    for n in calls:
        if n.func.attr not in ("kill", "terminate"):
            continue
        recv = ast.unparse(n.func.value)
        if not any(w == recv and ln > n.lineno for w, ln in waits):
            raw.append(Finding(
                "wait-after-kill", path, n.lineno,
                f"{recv}.{n.func.attr}() with no later {recv}.wait() "
                "in this function — no init reaper in this container: "
                "an unwaited child stays a zombie (pid-table leak; "
                "liveness probes lie)"))


def scan_file(path: str, source: Optional[str] = None, *,
              apply_suppressions: bool = True) -> List[Finding]:
    """All lifecycle findings for one file."""
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []                        # lint owns syntax errors
    parts = path.replace("\\", "/").split("/")
    base = parts[-1]
    # tests drive lifecycles out of order on purpose (crash-ordering
    # tests, teardown shortcuts); seeded fixtures are NOT exempt
    in_tests = (base.startswith("test_")
                or ("tests" in parts and "fixtures" not in parts))
    if in_tests:
        return []
    raw: List[Finding] = []
    for fn in _functions(tree):
        _check_publish_before_ready(fn, raw, path)
        _check_deregister_before_close(fn, raw, path)
        _check_log_after_success(fn, raw, path)
        _check_release_in_finally(fn, raw, path)
        _check_fresh_deadline(fn, raw, path)
        _check_wait_after_kill(fn, raw, path)
    if not apply_suppressions:
        return raw
    lines = source.splitlines()
    return [f for f in raw if not suppressed(lines, f.line, f.rule)]


def scan_files(paths) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        try:
            out += scan_file(p)
        except OSError:
            continue
    return out


__all__ = ["scan_file", "scan_files"]


from . import Pass, register_pass  # noqa: E402

register_pass(Pass(
    name="lifecycle",
    scan_paths=scan_files,
    raw_file=lambda path, source: scan_file(
        path, source, apply_suppressions=False),
))
