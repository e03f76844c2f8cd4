"""Control plane — remote command execution on test nodes.

The semantics of ``jepsen/control.clj``: a per-thread *session* (host +
transport + sudo/cd context) against which ``exec`` runs shell-escaped
commands (``control.clj:14-24,154``); ``on_nodes`` runs a function on
every node in parallel, each thread bound to that node's session
(``control.clj:310-319``).

The counterpart of the JAX package's ``control/__init__.py``, host code
issuing the same command strings; it also exports the pmux client
(:mod:`.pmux`), which the verifier daemon and its clients use for
service-name to port discovery.
"""

from __future__ import annotations

import shlex
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from .pmux import PmuxClient, resolve_layout
from .remote import (ExecResult, LocalRemote, RecordingRemote, Remote,
                     RemoteError, SSHRemote)

_tls = threading.local()


class Session:
    """A host + transport binding with sudo/cd context
    (``control.clj:14-24``)."""

    def __init__(self, host: str, remote: Remote,
                 sudo: Optional[str] = None, cwd: Optional[str] = None,
                 root: bool = False):
        self.host = host
        self.remote = remote
        self.sudo = sudo
        self.cwd = cwd
        self.root = root    # session already runs as root: su is a no-op

    def wrap(self, cmd: str) -> str:
        """Apply cd and sudo context (``control.clj:82-111``)."""
        if self.cwd:
            cmd = f"cd {shlex.quote(self.cwd)} && {cmd}"
        if self.sudo and not (self.root and self.sudo == "root"):
            cmd = f"sudo -S -u {self.sudo} sh -c {shlex.quote(cmd)}"
        return cmd

    def execute(self, cmd: str, timeout: Optional[float] = None
                ) -> ExecResult:
        return self.remote.execute(self.host, self.wrap(cmd), timeout)


def escape(arg: Any) -> str:
    """Shell-escape one argument (``control.clj:37-80``): sequences
    join with spaces unescaped (pre-built fragments); everything else is
    quoted when needed."""
    if isinstance(arg, (list, tuple)):
        return " ".join(escape(a) for a in arg)
    s = str(arg)
    return shlex.quote(s) if s else "''"


def lit(s: str) -> "Literal":
    """Mark a string as a raw shell fragment (no quoting) — the
    reference's ``c/lit``."""
    return Literal(s)


class Literal(str):
    pass


def build_cmd(*args: Any) -> str:
    return " ".join(a if isinstance(a, Literal) else escape(a)
                    for a in args)


# --- thread-local session binding (the reference's dynamic vars) -----------

def current_session() -> Optional[Session]:
    return getattr(_tls, "session", None)


class _SessionBinding:
    def __init__(self, session: Session):
        self.session = session

    def __enter__(self):
        self.saved = getattr(_tls, "session", None)
        _tls.session = self.session
        return self.session

    def __exit__(self, *exc):
        _tls.session = self.saved


def with_session(session: Session) -> _SessionBinding:
    return _SessionBinding(session)


def on(host: str, remote: Remote, **kw) -> _SessionBinding:
    return with_session(Session(host, remote, **kw))


def _require_session() -> Session:
    s = current_session()
    if s is None:
        raise RuntimeError("no control session bound on this thread; "
                           "use with_session/on/on_nodes")
    return s


def exec_(*args: Any, timeout: Optional[float] = None,
          check: bool = True) -> str:
    """Run a command on the current session; returns trimmed stdout,
    raises :class:`RemoteError` on nonzero exit (``control.clj:154``)."""
    s = _require_session()
    cmd = build_cmd(*args)
    res = s.execute(cmd, timeout=timeout)
    if check and not res.ok:
        raise RemoteError(cmd, res)
    return res.out.strip()


def su(*args: Any, **kw) -> str:
    """exec as root (``control.clj:96-103``)."""
    s = _require_session()
    root = Session(s.host, s.remote, sudo="root", cwd=s.cwd, root=s.root)
    with with_session(root):
        return exec_(*args, **kw)


def upload(local: str, remote_path: str) -> None:
    s = _require_session()
    s.remote.upload(s.host, local, remote_path)


def download(remote_path: str, local: str) -> None:
    s = _require_session()
    s.remote.download(s.host, remote_path, local)


# --- test-map integration ---------------------------------------------------

def make_remote(test: dict) -> Remote:
    """The transport for a test: ``test["remote"]`` if given, else SSH
    configured from ``test["ssh"]``."""
    r = test.get("remote")
    if r is not None:
        return r
    return SSHRemote(test.get("ssh") or {})


def session_for(test: dict, node: str) -> Session:
    sessions: Dict = test.setdefault("sessions", {})
    if node not in sessions:
        remote = make_remote(test)
        root = (test.get("ssh") or {}).get("username") == "root"
        if isinstance(remote, LocalRemote):
            import os
            root = root or os.geteuid() == 0
        sessions[node] = Session(node, remote, root=root)
    return sessions[node]


def on_nodes(test: dict, f: Callable[[dict, str], Any],
             nodes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run ``f(test, node)`` on every node in parallel, each thread
    bound to that node's session; returns {node: result}
    (``control.clj:310-319``)."""
    nodes = list(nodes if nodes is not None else (test.get("nodes") or []))
    results: Dict[str, Any] = {}
    errors: List[BaseException] = []
    lock = threading.Lock()

    def run1(node):
        try:
            with with_session(session_for(test, node)):
                r = f(test, node)
            with lock:
                results[node] = r
        except BaseException as e:
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=run1, args=(n,), daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def on_many(test: dict, nodes: Sequence[str],
            f: Callable[[dict, str], Any]) -> Dict[str, Any]:
    """on_nodes over an explicit node list (``control.clj:300-308``)."""
    return on_nodes(test, f, nodes=nodes)


__all__ = ["Session", "Remote", "SSHRemote", "LocalRemote",
           "RecordingRemote", "RemoteError", "ExecResult",
           "escape", "lit", "build_cmd", "exec_", "su", "upload",
           "download", "with_session", "on", "current_session",
           "session_for", "on_nodes", "on_many", "make_remote",
           "PmuxClient", "resolve_layout"]
