"""SQL-text workload clients — drive ``sut_node`` through its SQL
front end instead of the typed verbs.

The reference harness speaks ONLY SQL text: per-connection session
controls then text statements (``set hasql on``, ``set transaction
serializable``, ``set max_retries 100000`` — ``comdb2/core.clj:371-375``),
reads as SELECTs, writes as INSERT-or-UPDATE, cas as ``update ... where
id = ? and val = expected`` classified by affected-row count
(``comdb2/core.clj:432-474``, ``ctest/register.c:157-171``). These
clients issue the same statement shapes over the wire; the server
parses them into the typed verbs (``native/src/sql_front.cpp``, the
``db/sqlinterfaces.c:5970`` role). Replay safety rides ``SET cnonce``
(the cdb2api cnonce role) instead of the ``M`` wrapper.

The point is parity, not convenience: the same workloads and negative
controls must hold when driven through the query-language surface.

The counterpart of the JAX package's ``workloads/sql.py``: host code
sending the same statements.
"""

from __future__ import annotations

from ..ops.kv import tuple_
from .tcp import (ClusterTxn, G2TcpClient, SutConnection,
                  TcpClusterRegisterClient, TxnAborted)

SESSION_SETS = ("set hasql on", "set transaction serializable",
                "set max_retries 100000")


def _session_setup(conn: SutConnection) -> None:
    """The reference's per-connection session preamble."""
    for stmt in SESSION_SETS:
        if conn.request(stmt) != "OK":
            raise OSError(f"session setup failed: {stmt!r}")


class SqlTxn(ClusterTxn):
    """One SQL-text transaction (BEGIN .. COMMIT) with the ClusterTxn
    API, so the txn workload clients run unchanged over SQL. Only the
    statement text and control verbs differ; reply parsing is the
    shared ClusterTxn code."""

    _dml_ok = "ROWS 1"

    def _q_read(self, key: int) -> str:
        return f"select val from register where id = {key}"

    def _q_predicate(self, table: str, key: int) -> str:
        return f"select id, v from {table} where k = {key}"

    def _q_write(self, key: int, val: int) -> str:
        return f"update register set val = {val} where id = {key}"

    def _q_insert(self, table: str, key: int, rid: int,
                  val: int) -> str:
        return (f"insert into {table} (id, k, v) values "
                f"({rid}, {key}, {val})")

    def begin(self) -> None:
        reply = self.conn.request("begin")
        if reply.startswith("ERR transaction already open"):
            # a prior txn died server-side (conflict / failover) with
            # the session id still set — roll it back and retry once
            self.conn.request("rollback")
            reply = self.conn.request("begin")
        if reply != "OK":
            raise TxnAborted(f"begin failed: {reply}")
        self.txid = 0          # session-scoped; id lives server-side

    def commit(self, nonce: int = 0) -> str:
        if nonce:
            if self.conn.request(f"set cnonce {nonce}") != "OK":
                return "unknown"
        reply = self.conn.request("commit")
        if reply.startswith("OK"):
            return "ok"
        if reply == "FAIL":
            return "fail"
        return "unknown"

    def abort(self) -> None:
        try:
            self.conn.request("rollback")
        except (TimeoutError, OSError):
            pass


class SqlClusterRegisterClient(TcpClusterRegisterClient):
    """The register workload as SQL text with HA retry: reads are
    SELECTs, writes INSERT-or-UPDATE, cas the guarded UPDATE — each
    classified by rowcount like the reference client. Mutations carry
    ``SET cnonce`` so a retried statement that already applied replays
    its recorded outcome (blkseq dedup) on whichever node serves it."""

    def _clone(self):
        return SqlClusterRegisterClient(self.ports, self.timeout_s,
                                        self.mutate_retries)

    def _post_connect(self) -> None:
        _session_setup(self.conn)

    def _rotate(self) -> None:
        super()._rotate()
        # a fresh connection is a fresh SQL session
        try:
            self._post_connect()
        except (TimeoutError, OSError):
            pass               # next request surfaces the failure

    def _mutate_sql(self, stmt: str) -> str:
        """One nonce-carrying SQL mutation with retry-elsewhere;
        returns "OK" | "FAIL" | "UNKNOWN" (the _mutate contract)."""
        self._seq += 1
        nonce = (self._session << 24) | self._seq
        maybe_delivered = False
        for _ in range(self.mutate_retries):
            try:
                # side-effect-free session statement: a timeout here
                # means the mutation was never sent — rotate without
                # marking the attempt as possibly delivered
                if self.conn.request(f"set cnonce {nonce}") != "OK":
                    self._rotate()
                    continue
            except (TimeoutError, OSError):
                self._rotate()
                continue
            try:
                reply = self.conn.request(stmt)
            except TimeoutError:
                maybe_delivered = True      # sent, no complete reply
                self._rotate()
                continue
            except OSError:
                self._rotate()              # never connected: safe
                continue
            if reply == "ROWS 1":
                return "OK"
            if reply == "ROWS 0":
                return "FAIL"
            maybe_delivered = True
            self._rotate()
        return "UNKNOWN" if maybe_delivered else "FAIL"

    def invoke(self, test, op):
        f = op["f"]
        k, v = op["value"] if op["value"] is not None else (1, None)
        if f == "read":
            try:
                reply = self.conn.request(
                    f"select val from register where id = {k}")
            except (TimeoutError, OSError):
                return {**op, "type": "fail"}
            if reply == "NIL":
                return {**op, "type": "ok", "value": tuple_(k, None)}
            if reply.startswith("V "):
                return {**op, "type": "ok",
                        "value": tuple_(k, int(reply[2:]))}
            return {**op, "type": "fail"}
        if f == "write":
            reply = self._mutate_sql(
                f"insert into register (id, val) values ({k}, {v})")
        elif f == "cas":
            a, b = v
            reply = self._mutate_sql(
                f"update register set val = {b} "
                f"where id = {k} and val = {a}")
        else:
            raise ValueError(f"unknown f {f!r}")
        if reply == "OK":
            return {**op, "type": "ok"}
        if reply == "FAIL":
            return {**op, "type": "fail"}
        return {**op, "type": "info", "error": reply}


class SqlG2Client(G2TcpClient):
    """Adya G2 driven as SQL text: predicate SELECTs over tables a/b
    and a guarded INSERT, in one BEGIN..COMMIT (``jepsen/adya.clj:
    12-55``). Server-side OCC validation at commit is what must keep
    at most one insert per key — including under ``-T`` (buggy-txn),
    where the anomaly must surface through this surface too."""

    def _clone(self):
        return SqlG2Client(self.ports, self.timeout_s)

    def setup(self, test, node):
        c = super().setup(test, node)
        _session_setup(c.conn)
        return c

    def _make_txn(self):
        return SqlTxn(self.conn)
