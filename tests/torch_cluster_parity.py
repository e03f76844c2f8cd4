"""Shared helpers of the cluster slice's parity tests
(``tests/test_torch_{tcp_sut,replicated_sut,provision,txn_cluster,
sql_surface,crash_restart,register_nemesis_cluster}.py``): the native
binaries, ports taken from the OS, clusters that are always stopped,
and a scripted line server that records what a client sends.

Every port comes from the OS (a socket bound to port 0), never a fixed
number: the JAX package's cluster tests run on other workers at the same
moment. A cluster that fails to start because another process took one
of its ports between the probe and the bind is started again on fresh
ports.
"""

import contextlib
import fcntl
import os
import shutil
import socket
import subprocess
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")
#: the native targets the port's tests run or load
TARGETS = ("sut_node", "sut_server", "ct_register", "ct_sql",
           "libct_sut.so")
#: the port's own build tree (git-ignored): never the tree that
#: ``tests/test_native.py`` builds while other workers run
OWN_BUILD = os.path.join(ROOT, "comdb2_tpu_torch", "_build", "native")
#: a ``native/build`` younger than this may still be linking
SETTLED_S = 60.0

# the binaries' paths; the ``native_build`` fixture points them at the
# build it found or made before any test that needs them runs
BUILD = os.path.join(NATIVE, "build")
SUT_NODE = os.path.join(BUILD, "sut_node")
SUT_SERVER = os.path.join(BUILD, "sut_server")
CT_REGISTER = os.path.join(BUILD, "ct_register")
CT_SQL = os.path.join(BUILD, "ct_sql")

_BUILT = None


def _settled(build: str) -> bool:
    """``build`` holds every target, none of them written in the last
    :data:`SETTLED_S` seconds (a build still in progress may have some
    half-linked)."""
    paths = [os.path.join(build, t) for t in TARGETS]
    if not all(os.path.exists(p) for p in paths):
        return False
    return time.time() - max(os.path.getmtime(p) for p in paths) \
        > SETTLED_S


def build_native() -> str:
    """The directory holding the native targets: ``native/build`` when
    it holds them all, settled; else the port's own tree, built once
    with cmake under a file lock (xdist workers wait for one build)."""
    global _BUILT
    if _BUILT is None:
        if _settled(os.path.join(NATIVE, "build")):
            _BUILT = os.path.join(NATIVE, "build")
        else:
            os.makedirs(OWN_BUILD, exist_ok=True)
            with open(OWN_BUILD + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    subprocess.run(["cmake", "-S", NATIVE, "-B",
                                    OWN_BUILD], check=True,
                                   capture_output=True, timeout=300)
                    subprocess.run(["cmake", "--build", OWN_BUILD, "-j",
                                    "4"], check=True,
                                   capture_output=True, timeout=600)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
            _BUILT = OWN_BUILD
    return _BUILT


@pytest.fixture(scope="session")
def native_build():
    """The native targets, built at first use (see
    :func:`build_native`); skips only when cmake or a C++ compiler is
    missing. Points this module's binary paths at the build."""
    global BUILD, SUT_NODE, SUT_SERVER, CT_REGISTER, CT_SQL
    if shutil.which("cmake") is None or not (
            shutil.which("c++") or shutil.which("g++")):
        pytest.skip("cmake or a C++ compiler is missing")
    BUILD = build_native()
    SUT_NODE = os.path.join(BUILD, "sut_node")
    SUT_SERVER = os.path.join(BUILD, "sut_server")
    CT_REGISTER = os.path.join(BUILD, "ct_register")
    CT_SQL = os.path.join(BUILD, "ct_sql")
    return BUILD


#: the mark of a test that runs ``sut_node`` / ``sut_server``: the
#: binaries are built at first use (the module must import the
#: ``native_build`` fixture)
needs_sut_node = pytest.mark.usefixtures("native_build")
needs_sut_server = pytest.mark.usefixtures("native_build")


def free_ports(n):
    """``n`` distinct ports the OS handed out (bound together, then
    released)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def kill(procs):
    """SIGKILL every process and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def spawn(spawn_cluster, n, attempts=3, **kw):
    """``spawn_cluster(SUT_NODE, ports, **kw)`` on ``n`` fresh ports;
    returns ``(ports, procs)``. A start that fails (a port taken in the
    meantime) is retried on new ports."""
    for i in range(attempts):
        ports = free_ports(n)
        try:
            return ports, spawn_cluster(SUT_NODE, ports, **kw)
        except RuntimeError:
            if i == attempts - 1:
                raise


@contextlib.contextmanager
def cluster(spawn_cluster, n, **kw):
    """A running ``sut_node`` cluster, killed on the way out however the
    body ends; yields ``(ports, procs)``."""
    ports, procs = spawn(spawn_cluster, n, **kw)
    try:
        yield ports, procs
    finally:
        kill(procs)


def connect(conn_cls, port, timeout=2.0):
    c = conn_cls("127.0.0.1", port, timeout_s=timeout)
    c.connect()
    return c


# --- a scripted line server ---------------------------------------------------

#: a responder's answer: send nothing (the client's read times out)
SILENT = object()
#: a responder's answer: close the connection without a reply
CLOSE = object()


class Truncated(str):
    """A responder's answer: send these bytes without the newline, then
    close (a reply cut mid-line)."""


class LineServer:
    """A line-protocol server on a port the OS picks, one thread per
    connection. Every request line is recorded as ``(connection number,
    line)``; ``responder(line)`` answers it with a reply line, or
    :data:`SILENT`, :data:`CLOSE` or :class:`Truncated`. Used as a
    context manager, which closes every socket on the way out."""

    def __init__(self, responder):
        self.responder = responder
        self.lines = []
        self._lock = threading.Lock()
        self._conns = []
        self._threads = []
        self._closed = False
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]

    def __enter__(self):
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._closed = True
        try:
            # wakes the accept() blocked on it; close() alone does not
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def _accept(self):
        n = 0
        while not self._closed:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(c)
            t = threading.Thread(target=self._serve, args=(c, n),
                                 daemon=True)
            n += 1
            t.start()
            self._threads.append(t)

    def _serve(self, c, n):
        try:
            rfile = c.makefile("r")
            for line in rfile:
                line = line.rstrip("\n")
                with self._lock:
                    self.lines.append((n, line))
                reply = self.responder(line)
                if reply is SILENT:
                    continue
                if reply is CLOSE:
                    return
                if isinstance(reply, Truncated):
                    c.sendall(str(reply).encode())
                    return
                c.sendall((reply + "\n").encode())
        except OSError:
            pass
        finally:
            try:
                c.close()
            except OSError:
                pass


@contextlib.contextmanager
def line_servers(responders):
    """One :class:`LineServer` per responder; yields the servers."""
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(LineServer(r)) for r in responders]


def recorded(servers):
    """Every server's recorded lines, as ``(server, connection, line)``
    in each connection's order."""
    return [(i, n, line) for i, s in enumerate(servers)
            for n, line in sorted(s.lines, key=lambda x: x[0])]


def wait_until(pred, timeout_s, step_s=0.05):
    """Poll ``pred`` until it holds or ``timeout_s`` passes; returns its
    last value."""
    deadline = time.monotonic() + timeout_s
    while True:
        v = pred()
        if v or time.monotonic() > deadline:
            return v
        time.sleep(step_s)
