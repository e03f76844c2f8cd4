"""TCP SUT client — drive the native ``sut_server`` over its line
protocol.

This closes the distributed loop end to end: the harness's workers talk
to a real out-of-process SUT over sockets, socket timeouts surface as
indeterminate (``info``) completions exactly like the reference's
JDBC timeouts, and process faults (SIGSTOP on the server) produce the
hung-op behavior the checker must reason about.

The counterpart of the JAX package's ``workloads/tcp.py``: host code
sending the same request lines. The clients record nothing about a
device; the checkers a test composes run on the one it gives them.
"""

from __future__ import annotations

import random
import socket
import subprocess
import time
from typing import Optional, Sequence

from ..harness import client as client_ns
from ..ops.kv import tuple_


class SutConnection:
    """One line-protocol connection with a hard timeout."""

    def __init__(self, host: str, port: int, timeout_s: float = 1.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self.sock: Optional[socket.socket] = None
        self.rfile = None

    def connect(self) -> None:
        self.close()
        s = socket.create_connection(self.addr, timeout=self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = s
        self.rfile = s.makefile("r")

    def close(self) -> None:
        try:
            if self.rfile is not None:
                self.rfile.close()
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None
        self.rfile = None

    def request(self, line: str) -> str:
        """Send one request line; returns the reply line. Raises
        ``TimeoutError`` when the server doesn't answer in time (the
        op's outcome is then unknown — it may have applied)."""
        if self.sock is None:
            self.connect()
        try:
            self.sock.sendall((line + "\n").encode())
            reply = self.rfile.readline()
        except socket.timeout as e:
            self.close()
            raise TimeoutError(f"SUT timeout on {line!r}") from e
        except OSError as e:
            self.close()
            raise TimeoutError(f"SUT connection lost on {line!r}") from e
        if not reply.endswith("\n"):
            # empty = connection closed; partial = the server died or
            # stalled MID-REPLY — accepting "V 12" for "V 123" would
            # fabricate a wrong read under exactly the faults the
            # harness injects (same contract as ct_tcp_request's -2)
            self.close()
            raise TimeoutError(f"SUT truncated reply on {line!r}")
        return reply.strip()


class TcpRegisterClient(client_ns.Client):
    """read/write/cas against ``sut_server``; values are keyed
    ``(k, v)`` tuples like the comdb2 register client's. A timeout
    yields an ``info`` completion (indeterminate — the worker retires
    the process)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7777,
                 timeout_s: float = 1.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.conn: Optional[SutConnection] = None

    def setup(self, test, node):
        c = TcpRegisterClient(self.host, self.port, self.timeout_s)
        c.conn = SutConnection(self.host, self.port, self.timeout_s)
        c.conn.connect()
        return c

    def teardown(self, test):
        if self.conn is not None:
            self.conn.close()

    def invoke(self, test, op):
        f = op["f"]
        k, v = op["value"] if op["value"] is not None else (1, None)
        try:
            if f == "read":
                reply = self.conn.request("R")
                if reply == "NIL":
                    return {**op, "type": "ok", "value": tuple_(k, None)}
                if reply.startswith("V "):
                    return {**op, "type": "ok",
                            "value": tuple_(k, int(reply[2:]))}
                return {**op, "type": "fail"}
            if f == "write":
                reply = self.conn.request(f"W {v}")
            elif f == "cas":
                a, b = v
                reply = self.conn.request(f"C {a} {b}")
            else:
                raise ValueError(f"unknown f {f!r}")
            if reply == "OK" or reply.startswith("OK "):
                return {**op, "type": "ok"}
            if reply == "FAIL":
                return {**op, "type": "fail"}
            return {**op, "type": "info", "error": reply}
        except TimeoutError as e:
            return {**op, "type": "info", "error": str(e)}


class TcpClusterRegisterClient(TcpRegisterClient):
    """Register client against a replicated ``sut_node`` cluster: each
    worker talks to one node (cycled), so reads land on replicas and a
    partition between nodes is visible to the checker — the client-side
    shape of the reference's 5-node register test
    (``comdb2/core.clj:567-613``).

    Mutations ride replay nonces (``M <nonce> <cmd>``): an attempt whose
    outcome was lost is retried on the next node, and a node that
    already applied it replays the recorded outcome — the cdb2api HA
    retry backed by blkseq dedup. Only an exhausted retry budget
    surfaces as an indeterminate ``info`` op."""

    def __init__(self, ports, timeout_s: float = 1.0,
                 mutate_retries: int = 3):
        super().__init__("127.0.0.1", ports[0], timeout_s)
        self.ports = list(ports)
        self._next = 0
        self.mutate_retries = mutate_retries
        self._session = None
        self._seq = 0
        self._port_ix = 0

    def _clone(self):
        return TcpClusterRegisterClient(self.ports, self.timeout_s,
                                        self.mutate_retries)

    def _post_connect(self) -> None:
        """Per-connection preamble hook (the SQL client sends its
        session SETs here)."""

    def setup(self, test, node):
        port_ix = self._next % len(self.ports)
        self._next += 1
        c = self._clone()
        c._port_ix = port_ix
        c._session = random.SystemRandom().getrandbits(32)
        c.conn = SutConnection(self.host, self.ports[port_ix],
                               self.timeout_s)
        c.conn.connect()
        c._post_connect()
        return c

    def _rotate(self) -> None:
        """Reconnect to the next node (retry-elsewhere)."""
        self._port_ix = (self._port_ix + 1) % len(self.ports)
        self.conn.close()
        self.conn = SutConnection(self.host, self.ports[self._port_ix],
                                  self.timeout_s)

    def _mutate(self, cmd: str) -> str:
        """Send one nonce-wrapped mutation with retry-elsewhere;
        returns the final reply ("UNKNOWN" when the budget exhausts)."""
        self._seq += 1
        nonce = (self._session << 24) | self._seq
        line = f"M {nonce} {cmd}"
        maybe_delivered = False
        for _ in range(self.mutate_retries):
            try:
                reply = self.conn.request(line)
            except TimeoutError:
                maybe_delivered = True      # sent, no complete reply
                self._rotate()
                continue
            except OSError:
                self._rotate()              # never connected: safe
                continue
            if reply.startswith("OK") or reply == "FAIL":
                return reply
            maybe_delivered = True      # delivered, outcome unresolved
            self._rotate()
        # FAIL is only safe when no attempt can have been delivered
        return "UNKNOWN" if maybe_delivered else "FAIL"

    def invoke(self, test, op):
        """Keyed commands (``R k`` / ``W k v`` / ``C k a b``): the
        cluster stores one register per key like the reference's
        register table, and the independent checker verifies per key."""
        f = op["f"]
        k, v = op["value"] if op["value"] is not None else (1, None)
        if f == "read":
            # reads have no side effects, so any failure is safely
            # :fail (never pends) — an info read would stay pending
            # forever and pending ops are what blow up the checker
            try:
                reply = self.conn.request(f"R {k}")
            except (TimeoutError, OSError):
                return {**op, "type": "fail"}
            if reply == "NIL":
                return {**op, "type": "ok", "value": tuple_(k, None)}
            if reply.startswith("V "):
                return {**op, "type": "ok",
                        "value": tuple_(k, int(reply[2:]))}
            return {**op, "type": "fail"}
        if f == "write":
            reply = self._mutate(f"W {k} {v}")
        elif f == "cas":
            a, b = v
            reply = self._mutate(f"C {k} {a} {b}")
        else:
            raise ValueError(f"unknown f {f!r}")
        if reply.startswith("OK"):
            return {**op, "type": "ok"}
        if reply == "FAIL":
            return {**op, "type": "fail"}
        return {**op, "type": "info", "error": reply}


class ClusterControl:
    """Admin-plane driver for a ``sut_node`` cluster: cluster/primary
    discovery (the ``cdb2_cluster_info`` / ``sys.cmd.send('bdb
    cluster')`` role, ``ctest/nemesis.c:15-47``) and symmetric
    partitions over the B/U control verbs."""

    def __init__(self, ports, timeout_s: float = 2.0):
        self.ports = list(ports)
        self.timeout_s = timeout_s

    def _req(self, port: int, line: str) -> str:
        conn = SutConnection("127.0.0.1", port, self.timeout_s)
        try:
            conn.connect()
            return conn.request(line)
        finally:
            conn.close()

    def info(self):
        """[{node, role, applied, durable, term, leader}] for reachable
        nodes; ``durable`` is meaningful on the current primary only."""
        out = []
        for i, port in enumerate(self.ports):
            try:
                r = self._req(port, "I").split()
                d = {"node": int(r[1]), "role": r[2],
                     "applied": int(r[3]), "durable": int(r[4]),
                     "port": port}
                if len(r) >= 7:
                    d["term"] = int(r[5])
                    d["leader"] = int(r[6])
                out.append(d)
            except (TimeoutError, OSError, IndexError, ValueError):
                out.append({"node": i, "role": "down", "port": port})
        return out

    def primary(self):
        """Discovered primary node id, or None."""
        for n in self.info():
            if n["role"] == "primary":
                return n["node"]
        return None

    def partition(self, side_a, side_b) -> None:
        """Symmetric partition: every node in side_a drops traffic with
        every node in side_b and vice versa (the grudge map shape of
        ``nemesis.clj:21-27``). Best-effort like the iptables nemesis:
        an unreachable node's verbs are skipped rather than aborting
        half-installed."""
        for a in side_a:
            for b in side_b:
                for port, peer in ((self.ports[a], b),
                                   (self.ports[b], a)):
                    try:
                        self._req(port, f"B {peer}")
                    except (TimeoutError, OSError):
                        pass

    def heal(self) -> None:
        for port in self.ports:
            try:
                self._req(port, "U")
            except (TimeoutError, OSError):
                pass

    def clock(self, node: int, offset_ms: int) -> bool:
        """Set node's wall-clock offset (the in-tree ``date -s`` — the
        K verb). Reset with 0. Returns whether the command landed —
        best-effort callers (nemeses) ignore it, but deterministic
        tests must assert it (a silently-dropped clock jump would turn
        a control-plane failure into a misleading verdict)."""
        try:
            return self._req(self.ports[node],
                             f"K {offset_ms}") == "OK"
        except (TimeoutError, OSError):
            return False

    def clocks_reset(self) -> None:
        for i in range(len(self.ports)):
            self.clock(i, 0)

    def await_replicated(self, timeout_s: float = 10.0) -> bool:
        """Coherency gate: wait until every node's applied LSN matches
        the primary's (the ``blockcoherent.sh:15-37`` role)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = self.info()
            applied = [n.get("applied") for n in info]
            if all(a is not None for a in applied) and \
                    len(set(applied)) == 1:
                return True
            time.sleep(0.1)
        return False


class ClusterPartitioner:
    """Nemesis client: on ``start`` discovers the primary and cuts
    {primary, one random other node} off from the rest — the
    highest-yield fault of the reference suite (``nemesis.c:90-144``
    breaknet targets master+1); on ``stop`` heals."""

    def __init__(self, control: ClusterControl, rng=None,
                 isolate_primary: bool = False):
        """``isolate_primary`` cuts the primary ALONE from everyone —
        in an N=3 cluster the breaknet shape {master, +1} keeps a
        majority on the master's side, so isolating the primary is the
        variant that actually denies it quorum."""
        self.control = control
        self.rng = rng or random.Random(0)
        self.isolate_primary = isolate_primary

    def setup(self, test, node):
        return self

    def teardown(self, test):
        self.control.heal()

    def invoke(self, test, op):
        n = len(self.control.ports)
        if op["f"] == "start":
            primary = self.control.primary()
            if primary is None:
                primary = 0
            others = [i for i in range(n) if i != primary]
            extra = ([] if self.isolate_primary or len(others) <= 1
                     else [self.rng.choice(others)])
            side_a = [primary] + extra
            side_b = [i for i in range(n) if i not in side_a]
            self.control.partition(side_a, side_b)
            return {**op, "value": f"cut {side_a} from {side_b}"}
        self.control.heal()
        return dict(op)


class ClusterProcs(list):
    """The ``sut_node`` processes of one cluster, with enough spawn
    context to KILL -9 and RESTART members mid-run — the killcluster
    disruptor's handle (``killclustertest.sh:36-84`` kill-9s real DB
    processes and relies on txn-log recovery). Subclasses list so
    existing ``for p in procs: p.kill()`` teardowns keep working."""

    def __init__(self, procs, argv_per_node, ports, wait_s=5.0):
        super().__init__(procs)
        self.argv_per_node = argv_per_node
        self.ports = list(ports)
        self.wait_s = wait_s

    def kill9(self, i: int) -> None:
        """SIGKILL node ``i`` (no shutdown path runs — buffered,
        un-fsynced state dies with the process)."""
        self[i].kill()
        self[i].wait()

    def restart(self, i: int, wait_ready: bool = True) -> None:
        """Restart node ``i`` with its original argv (same state dir:
        recovery replays the log)."""
        self[i] = subprocess.Popen(self.argv_per_node[i],
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
        if wait_ready:
            _wait_ready(self[i], self.ports[i],
                        time.monotonic() + self.wait_s, "sut_node")

    def kill9_all(self) -> None:
        for i in range(len(self)):
            self[i].kill()
        for i in range(len(self)):
            self[i].wait()

    def restart_all(self) -> None:
        for i in range(len(self)):
            self.restart(i, wait_ready=False)
        deadline = time.monotonic() + self.wait_s
        for i, port in enumerate(self.ports):
            _wait_ready(self[i], port, deadline, "sut_node")


class ClusterClockScrambler:
    """Nemesis client: on ``start`` scrambles every node's wall clock
    by a random offset within ±max_skew_ms (the ``clock-scrambler``
    role, ``nemesis.clj:172-187``, over the SUT's K verb instead of
    ``date -s``); on ``stop`` resets all clocks. Harmless against the
    monotonic-lease implementation; the --bad-lease control is what
    gives it teeth."""

    def __init__(self, control: ClusterControl, rng=None,
                 max_skew_ms: int = 60_000):
        self.control = control
        self.rng = rng or random.Random(0)
        self.max_skew_ms = max_skew_ms

    def setup(self, test, node):
        return self

    def teardown(self, test):
        self.control.clocks_reset()

    def invoke(self, test, op):
        if op["f"] == "start":
            offs = []
            for i in range(len(self.control.ports)):
                off = self.rng.randint(-self.max_skew_ms,
                                       self.max_skew_ms)
                self.control.clock(i, off)
                offs.append(off)
            return {**op, "value": f"clock offsets {offs}"}
        self.control.clocks_reset()
        return dict(op)


def spawn_cluster(binary: str, ports, durable: bool = True,
                  timeout_ms: int = 2000, wait_s: float = 5.0,
                  elect_ms: Optional[int] = None,
                  lease_ms: Optional[int] = None,
                  dirs: Optional[Sequence[str]] = None,
                  flags: Sequence[str] = ()) -> "ClusterProcs":
    """Start one ``sut_node`` per port on localhost; returns a
    :class:`ClusterProcs` once every node answers PING.
    ``elect_ms``/``lease_ms`` tune the failover timings; ``dirs`` gives
    each node a persistent state directory (crash-restart recovery);
    ``flags`` passes extra per-node options (e.g. ``["-B"]`` for the
    split-brain control, ``["-x"]`` for no-fsync)."""
    plist = ",".join(str(p) for p in ports)
    argv_per_node = []
    procs = []
    for i in range(len(ports)):
        args = [binary, "-i", str(i), "-n", plist,
                "-t", str(timeout_ms)]
        if elect_ms is not None:
            args += ["-e", str(elect_ms)]
        if lease_ms is not None:
            args += ["-l", str(lease_ms)]
        if dirs is not None:
            args += ["-d", str(dirs[i])]
        if not durable:
            args.append("-N")
        args += list(flags)
        argv_per_node.append(args)
        procs.append(subprocess.Popen(args,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL))
    cluster = ClusterProcs(procs, argv_per_node, ports, wait_s=wait_s)
    deadline = time.monotonic() + wait_s
    try:
        for i, port in enumerate(ports):
            _wait_ready(procs[i], port, deadline, "sut_node")
    except RuntimeError:
        cluster.kill9_all()
        raise
    return cluster


def _wait_ready(proc, port: int, deadline: float, name: str) -> None:
    """Poll until the server answers PING, it dies, or the deadline
    passes (shared by spawn_server/spawn_cluster)."""
    conn = SutConnection("127.0.0.1", port, timeout_s=0.3)
    while True:
        rc = proc.poll()
        if rc is not None:          # died at startup (port taken, …)
            raise RuntimeError(
                f"{name} on port {port} exited rc={rc} at startup")
        if time.monotonic() > deadline:
            raise RuntimeError(f"{name} on port {port} never became ready")
        try:
            conn.connect()
            if conn.request("P") == "PONG":
                conn.close()
                return
        except (OSError, TimeoutError):
            time.sleep(0.05)


def spawn_server(binary: str, port: int, *flags: str,
                 wait_s: float = 5.0) -> "subprocess.Popen":
    """Start a local sut_server and wait until it answers PING."""
    proc = subprocess.Popen([binary, "-p", str(port), *flags],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait_ready(proc, port, time.monotonic() + wait_s, "sut_server")
    except RuntimeError:
        proc.kill()
        proc.wait()
        raise
    return proc


class ClusterTxn:
    """One wire transaction against a ``sut_node`` cluster — the
    client side of the TB/TR/TP/TW/TI/TC verbs (the cdb2 begin/.../
    commit surface; server-side OCC validation at commit). All verbs
    forward to the leader, so the txn can be driven through any node."""

    def __init__(self, conn: SutConnection):
        self.conn = conn
        self.txid: Optional[int] = None

    # request-line builders + success token: the SQL-surface txn
    # (:mod:`.sql`) overrides ONLY these; reply parsing is shared so
    # the two surfaces cannot silently disagree on shapes
    _dml_ok = "OK"

    def _q_read(self, key: int) -> str:
        return f"TR {self.txid} {key}"

    def _q_predicate(self, table: str, key: int) -> str:
        return f"TP {self.txid} {table} {key}"

    def _q_write(self, key: int, val: int) -> str:
        return f"TW {self.txid} {key} {val}"

    def _q_insert(self, table: str, key: int, rid: int,
                  val: int) -> str:
        return f"TI {self.txid} {table} {key} {rid} {val}"

    def begin(self) -> None:
        reply = self.conn.request("TB")
        if not reply.startswith("T "):
            raise TxnAborted(f"begin failed: {reply}")
        self.txid = int(reply[2:])

    def read(self, key: int) -> Optional[int]:
        reply = self.conn.request(self._q_read(key))
        if reply == "NIL":
            return None
        if reply.startswith("V "):
            return int(reply[2:])
        raise TxnAborted(f"read failed: {reply}")

    def predicate(self, table: str, key: int):
        """All committed rows of (table, key) as [(id, value)]."""
        reply = self.conn.request(self._q_predicate(table, key))
        if not reply.startswith("V"):
            raise TxnAborted(f"predicate failed: {reply}")
        rows = []
        for tok in reply[1:].split():
            rid, val = tok.split(":")
            rows.append((int(rid), int(val)))
        return rows

    def write(self, key: int, val: int) -> None:
        reply = self.conn.request(self._q_write(key, val))
        if reply != self._dml_ok:
            raise TxnAborted(f"write failed: {reply}")

    def insert(self, table: str, key: int, rid: int, val: int) -> None:
        reply = self.conn.request(self._q_insert(table, key, rid, val))
        if reply != self._dml_ok:
            raise TxnAborted(f"insert failed: {reply}")

    def commit(self, nonce: int = 0) -> str:
        """Returns "ok" | "fail" | "unknown"."""
        line = (f"TC {self.txid} {nonce}" if nonce
                else f"TC {self.txid}")
        reply = self.conn.request(line)
        if reply.startswith("OK"):
            return "ok"
        if reply == "FAIL":
            return "fail"
        return "unknown"

    def abort(self) -> None:
        try:
            self.conn.request(f"TA {self.txid}")
        except (TimeoutError, OSError):
            pass


class TxnAborted(Exception):
    """A txn verb failed server-side (conflict / failover): the txn is
    dead and nothing was applied — a clean :fail for mutations."""


class _ClusterTxnClientBase(client_ns.Client):
    """Shared plumbing for txn workload clients: per-worker node
    assignment (cycled), a txn runner that maps conflicts to ``fail``
    and lost outcomes to ``info``."""

    def __init__(self, ports, timeout_s: float = 1.0):
        self.ports = list(ports)
        self.timeout_s = timeout_s
        self._next = 0
        self.conn: Optional[SutConnection] = None
        self._session = 0
        self._seq = 0

    def _clone(self):
        raise NotImplementedError

    def setup(self, test, node):
        c = self._clone()
        port = self.ports[self._next % len(self.ports)]
        self._next += 1
        c.conn = SutConnection("127.0.0.1", port, self.timeout_s)
        c.conn.connect()
        c._session = random.SystemRandom().getrandbits(32)
        return c

    def teardown(self, test):
        if self.conn is not None:
            self.conn.close()

    def _nonce(self) -> int:
        self._seq += 1
        return (self._session << 24) | self._seq

    def _make_txn(self):
        """Txn factory — the SQL-surface clients (:mod:`.sql`) swap in
        a text-statement txn here; everything else is shared."""
        return ClusterTxn(self.conn)

    def _run_txn(self, op, body, read_only=False):
        """Run ``body(txn)`` in one wire txn; body returns the ``ok``
        completion (or a full completion dict to use verbatim)."""
        txn = self._make_txn()
        try:
            txn.begin()
            out = body(txn)
            if isinstance(out, dict) and out.get("type") != "ok":
                txn.abort()
                return out
            verdict = txn.commit(0 if read_only else self._nonce())
            if verdict == "ok":
                if isinstance(out, dict):
                    return out
                if out is None:
                    # keep the INVOKED value (e.g. G2's (key, ids) —
                    # the checker keys on it); body returns a value
                    # only when the completion carries new data
                    return {**op, "type": "ok"}
                return {**op, "type": "ok", "value": out}
            if verdict == "fail":
                return {**op, "type": "fail"}
            return {**op, "type": ("fail" if read_only else "info"),
                    "error": "commit unknown"}
        except TxnAborted as e:
            return {**op, "type": "fail", "error": str(e)}
        except (TimeoutError, OSError) as e:
            # a lost reply mid-txn: reads are side-effect-free (fail);
            # a lost COMMIT reply is indeterminate (info)
            return {**op, "type": ("fail" if read_only else "info"),
                    "error": str(e)}


class BankTcpClient(_ClusterTxnClientBase):
    """The bank workload over the wire (``comdb2/core.clj:71-129``):
    accounts are registers keyed 0..n-1; transfers read both balances
    and write both back in one OCC txn — serializability of the commit
    validation is what keeps the total balance invariant."""

    def __init__(self, ports, n: int, starting_balance: int = 10,
                 timeout_s: float = 1.0):
        super().__init__(ports, timeout_s)
        self.n = n
        self.starting_balance = starting_balance

    def _clone(self):
        return BankTcpClient(self.ports, self.n, self.starting_balance,
                             self.timeout_s)

    def setup(self, test, node):
        c = super().setup(test, node)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            txn = ClusterTxn(c.conn)
            try:
                txn.begin()
                missing = [i for i in range(c.n)
                           if txn.read(i) is None]
                for i in missing:
                    txn.write(i, c.starting_balance)
                if txn.commit(c._nonce()) == "ok" or not missing:
                    return c
            except (TxnAborted, TimeoutError, OSError):
                pass
            time.sleep(0.1)
        raise RuntimeError("could not initialize bank accounts")

    def invoke(self, test, op):
        if op["f"] == "read":
            def body(txn):
                balances = []
                for i in range(self.n):
                    v = txn.read(i)
                    if v is None:
                        raise TxnAborted("uninitialized account")
                    balances.append(v)
                return tuple(balances)
            return self._run_txn(op, body, read_only=True)
        if op["f"] == "transfer":
            v = op["value"]
            frm, to, amount = v["from"], v["to"], v["amount"]

            def body(txn):
                b1 = txn.read(frm)
                b2 = txn.read(to)
                if b1 is None or b2 is None:
                    raise TxnAborted("uninitialized account")
                if b1 - amount < 0:
                    return {**op, "type": "fail",
                            "value": ("negative", frm, b1 - amount)}
                txn.write(frm, b1 - amount)
                txn.write(to, b2 + amount)
                return None
            return self._run_txn(op, body)
        raise ValueError(f"unknown f {op['f']!r}")


class G2TcpClient(_ClusterTxnClientBase):
    """Adya G2 over the wire (``jepsen/adya.clj:12-55``): predicate-
    read tables a and b for the key; if neither holds a matching row,
    insert this op's id into its table. Phantom safety comes from the
    server's per-(table, key) version validation at commit: at most
    one insert can commit per key."""

    def _clone(self):
        return G2TcpClient(self.ports, self.timeout_s)

    def invoke(self, test, op):
        k, ids = op["value"]
        a_id, b_id = ids

        def body(txn):
            a = [r for r in txn.predicate("a", k) if r[1] % 3 == 0]
            b = [r for r in txn.predicate("b", k) if r[1] % 3 == 0]
            if a or b:
                return {**op, "type": "fail"}
            if a_id is not None:
                txn.insert("a", k, a_id, 30)
            else:
                txn.insert("b", k, b_id, 30)
            return None
        return self._run_txn(op, body)


class DirtyReadsTcpClient(_ClusterTxnClientBase):
    """The dirty-reads workload over the wire
    (``comdb2/core.clj:320-355``): ``write x`` updates every row of the
    dirty table to x in ONE txn (reading each row first, so the commit
    carries a read set); ``read`` returns all rows' values from one
    read-only txn. A row value from a write that reported :fail is the
    anomaly (``core.clj:492-523``); a non-uniform read is an
    inconsistent (torn) read. The ``-R`` dirty-commit control applies
    conflicted txns while reporting FAIL — the classic
    effects-misclassification bug this workload exists to catch.

    Rows live at register keys ``base .. base+n-1`` (base offsets the
    dirty table away from other workloads' keys)."""

    def __init__(self, ports, n: int, base: int = 10_000,
                 timeout_s: float = 1.0):
        super().__init__(ports, timeout_s)
        self.n = n
        self.base = base

    def _clone(self):
        return DirtyReadsTcpClient(self.ports, self.n, self.base,
                                   self.timeout_s)

    def setup(self, test, node):
        c = super().setup(test, node)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            txn = ClusterTxn(c.conn)
            try:
                txn.begin()
                missing = [i for i in range(c.n)
                           if txn.read(c.base + i) is None]
                for i in missing:
                    txn.write(c.base + i, -1)
                if txn.commit(c._nonce()) == "ok" or not missing:
                    return c
            except (TxnAborted, TimeoutError, OSError):
                pass
            time.sleep(0.1)
        raise RuntimeError("could not initialize dirty rows")

    def invoke(self, test, op):
        if op["f"] == "read":
            def body(txn):
                vals = []
                for i in range(self.n):
                    v = txn.read(self.base + i)
                    if v is None:
                        raise TxnAborted("uninitialized row")
                    vals.append(v)
                # skip initializer rows, like the reference's
                # ``where x != -1`` (core.clj:341)
                return tuple(v for v in vals if v != -1)
            return self._run_txn(op, body, read_only=True)
        if op["f"] == "write":
            x = op["value"]
            order = list(range(self.n))
            random.shuffle(order)

            def body(txn):
                for i in order:
                    txn.read(self.base + i)
                for i in order:
                    txn.write(self.base + i, x)
                return None
            return self._run_txn(op, body)
        raise ValueError(f"unknown f {op['f']!r}")


class ListAppendTcpClient(_ClusterTxnClientBase):
    """Elle's list-append workload over the wire txn surface: appends
    are inserts into table ``a`` at ``BASE + k`` (insert-only, so the
    server's per-(table, key) row-count validation gives appends the
    same conflict rules as the G2 workload), reads are predicate
    reads returning the key's rows in log order — the WHOLE list,
    so committed reads recover the version order Elle-style. Reads
    see the txn's own buffered appends (client-side fixup: the wire
    predicate read serves the committed prefix only)."""

    BASE = 30_000

    def _clone(self):
        return ListAppendTcpClient(self.ports, self.timeout_s)

    def invoke(self, test, op):
        def body(txn):
            done = []
            own: dict = {}
            for f, k, v in op["value"]:
                if f == "append":
                    txn.insert("a", self.BASE + k, v, v)
                    own.setdefault(k, []).append(v)
                    done.append(("append", k, v))
                else:
                    rows = txn.predicate("a", self.BASE + k)
                    vals = [val for _rid, val in rows] + own.get(k, [])
                    done.append(("r", k, tuple(vals)))
            return {**op, "type": "ok", "value": tuple(done)}
        return self._run_txn(op, body)


class CounterTcpClient(_ClusterTxnClientBase):
    """The counter workload over the wire (``checker.clj:220-272``):
    ``add v`` reads the counter register and writes back the sum in one
    OCC txn (a conflicted add cleanly fails and is retried by the
    generator's next op); ``read`` returns the register from a
    read-only txn. ``-T`` (no validation) loses concurrent updates, so
    a later read falls below the sum of acknowledged adds — the
    counter checker's lower bound."""

    KEY = 20_000

    def _clone(self):
        return CounterTcpClient(self.ports, self.timeout_s)

    def invoke(self, test, op):
        if op["f"] == "read":
            def body(txn):
                v = txn.read(self.KEY)
                return 0 if v is None else v
            return self._run_txn(op, body, read_only=True)
        if op["f"] == "add":
            v = op["value"]

            def body(txn):
                cur = txn.read(self.KEY)
                txn.write(self.KEY, (0 if cur is None else cur) + v)
                return None
            return self._run_txn(op, body)
        raise ValueError(f"unknown f {op['f']!r}")
