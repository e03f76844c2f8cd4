"""Clients for the verifier daemon — retry/backoff over the newline-
JSON protocol, and consistent-hash routing over a pmux-discovered
daemon fleet.

``check`` is pure verification (no side effects on the daemon beyond
metrics), so a lost connection retries the SAME request safely — the
cdb2api HA-retry shape without needing replay nonces. Only an
exhausted retry budget surfaces to the caller. Overload replies carry
the daemon's ``retry_after_ms`` hint (queue depth / drain rate);
:class:`ServiceClient` honors it with JITTERED backoff — fixed-
interval retries from N clients re-arrive as one synchronized wave
and shed again.

:class:`RoutedClient` is the horizontal-scale surface: daemons
register under ``sut/verifier/<shard>`` (``--pmux-shard``), discovery
reads every registration from ``ct_pmux``, and requests route by
consistent hash of the history payload — the same history lands on
the same daemon (warm programs, warm carry pool) and adding a daemon
remaps only ~1/N of the keyspace. A dead daemon fails over to the
next on the ring.
"""

from __future__ import annotations

import hashlib
import random
import socket
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Union

from ..obs.trace import monotonic as _monotonic
from . import protocol
from .daemon import PMUX_SERVICE


class ServiceError(Exception):
    """The daemon answered ``ok: false`` (``.code`` holds the error
    code, e.g. ``"overload"``; ``.retry_after_ms`` the backoff hint
    when the reply carried one — the routed failover honors it
    per node)."""

    def __init__(self, code: str, message: str = "",
                 retry_after_ms: Optional[float] = None):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code
        self.retry_after_ms = retry_after_ms

    @classmethod
    def from_reply(cls, reply: dict) -> "ServiceError":
        return cls(reply.get("error", "unknown-error"),
                   reply.get("message", ""),
                   reply.get("retry_after_ms"))


def _checked(reply: dict, raise_on_error: bool) -> dict:
    if raise_on_error and not reply.get("ok"):
        raise ServiceError.from_reply(reply)
    return reply


class ServiceClient:
    """One connection to the daemon, redialed on failure."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5107,
                 timeout_s: float = 120.0, retries: int = 3,
                 backoff_s: float = 0.05, overload_retries: int = 2):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        #: extra attempts on an explicit overload reply, each after a
        #: jittered sleep around the daemon's retry_after_ms hint
        #: (0 = surface overload immediately)
        self.overload_retries = overload_retries
        self._rng = random.Random()
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._seq = 0

    @classmethod
    def discover(cls, pmux_port: int = 5105,
                 service: str = PMUX_SERVICE, host: str = "127.0.0.1",
                 **kw) -> "ServiceClient":
        """Resolve the daemon's port through pmux (the port-less
        discovery path the native SUT clients use)."""
        from ..control.pmux import PmuxClient

        with PmuxClient(host, pmux_port) as c:
            port = c.get(service)
        if port is None:
            raise OSError(f"pmux does not know {service!r}")
        return cls(host, port, **kw)

    # -- plumbing ------------------------------------------------------

    def _conn(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._file = self._sock.makefile("rb")
        return self._sock, self._file

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._file = None

    def _request(self, obj: dict) -> dict:
        """Send one request, await its reply; redial + retry with
        backoff on connection failure (checks are idempotent)."""
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                sock, f = self._conn()
                sock.sendall(protocol.encode(obj))
                line = f.readline()
                if not line.endswith(b"\n"):
                    # truncated = daemon died mid-reply; same contract
                    # as the SUT client's partial-reply rejection
                    raise OSError("truncated reply")
                return protocol.decode(line)
            except (OSError, ValueError) as e:
                last = e
                self.close()
        raise OSError(f"verifier at {self.host}:{self.port} "
                      f"unreachable after {self.retries + 1} "
                      f"attempts: {last}")

    def _request_shedding(self, req: dict) -> dict:
        """One request with overload backoff: an ``overload`` reply
        sleeps around the daemon's ``retry_after_ms`` hint with
        +/-50% jitter (N clients backing off the same hint must not
        re-arrive as one synchronized wave) and retries up to
        ``overload_retries`` times before surfacing the reply. The
        request's own ``deadline_ms`` caps the cumulative backoff: a
        sleep that would blow the caller's budget surfaces the
        overload instead of silently turning a 100 ms check into a
        multi-second blocking call."""
        budget_ms = req.get("deadline_ms")
        t0 = _monotonic()
        for attempt in range(self.overload_retries + 1):
            reply = self._request(req)
            if (reply.get("ok")
                    or reply.get("error") != protocol.OVERLOAD
                    or attempt == self.overload_retries):
                return reply
            hint_ms = reply.get("retry_after_ms")
            if not isinstance(hint_ms, (int, float)) or hint_ms <= 0:
                hint_ms = 100.0
            sleep_s = hint_ms / 1e3 * self._rng.uniform(0.5, 1.5)
            if budget_ms is not None and \
                    (_monotonic() - t0 + sleep_s) * 1e3 \
                    > float(budget_ms):
                return reply
            time.sleep(sleep_s)
        return reply

    # -- API -----------------------------------------------------------

    def check(self, history: Union[str, List, None] = None, *,
              model: Optional[str] = None, keyed: bool = False,
              deadline_ms: Optional[int] = None,
              txn: bool = False, realtime: bool = False,
              raise_on_error: bool = True) -> dict:
        """Verify one history. ``history`` is EDN text or a list of
        ``Op``s (serialized via ``history_to_edn``). ``txn=True``
        submits the serializability kind (list-append txn ops; the
        reply carries ``anomaly_class``/``cycle`` on violations).
        Returns the reply dict (``valid`` is the tri-state);
        daemon-side errors raise :class:`ServiceError` unless
        ``raise_on_error=False``."""
        history = _as_edn(history)
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq,
                     "history": history}
        if txn:
            req["kind"] = "txn"
            if realtime:
                req["realtime"] = True
        if model is not None:
            req["model"] = model
        if keyed:
            req["keyed"] = True
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        reply = self._request_shedding(req)
        return _checked(reply, raise_on_error)

    def check_wl(self, history: Union[str, List, None], family: str,
                 *, wl: Optional[dict] = None,
                 deadline_ms: Optional[int] = None,
                 raise_on_error: bool = True) -> dict:
        """Check one workload-family history (``kind:"wl"``,
        docs/workloads.md): ``family`` is ``"bank"``/``"sets"``/
        ``"dirty"``; bank takes ``wl={"n":..,"total":..}``. The reply
        carries the host oracle's verdict fields (``bad-reads`` /
        ``lost`` / ``dirty-reads`` ...) plus ``engine``/``bucket``
        attribution — bit-identical to the in-process
        ``check_wl_batch``."""
        history = _as_edn(history)
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq, "kind": "wl",
                     "family": family, "history": history}
        if wl is not None:
            req["wl"] = wl
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        reply = self._request_shedding(req)
        return _checked(reply, raise_on_error)

    def shrink(self, history: Union[str, List, None] = None, *,
               model: Optional[str] = None, keyed: bool = False,
               txn: bool = False, realtime: bool = False,
               deadline_ms: Optional[int] = None,
               raise_on_error: bool = True) -> dict:
        """Minimize one INVALID history (``kind: "shrink"``). The
        reply carries ``minimal_history`` (EDN text of the 1-minimal
        sub-history), ``minimal_ops``/``seed_ops``, round/dispatch
        counts and the ``one_minimal``/``partial`` flags; a deadline
        returns best-so-far flagged ``partial``. A VALID/UNKNOWN seed
        answers ``bad-request`` (shrinking it is an error, not a
        loop)."""
        history = _as_edn(history)
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq, "kind": "shrink",
                     "history": history}
        if txn:
            req["txn"] = True
            if realtime:
                req["realtime"] = True
        if model is not None:
            req["model"] = model
        if keyed:
            req["keyed"] = True
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        reply = self._request_shedding(req)
        return _checked(reply, raise_on_error)

    # -- streaming sessions (kind:"stream", docs/streaming.md) ---------

    def stream_open(self, *, model: Optional[str] = None,
                    keyed: bool = False, rung: Optional[str] = None,
                    checkpoint: Optional[dict] = None,
                    wl: Optional[dict] = None,
                    raise_on_error: bool = True) -> dict:
        """Open a streaming session; the reply carries ``session``
        (the id every later verb names). An ``overload`` reply means
        the daemon's session table is at cap — back off on its
        ``retry_after_ms`` like any other overload. ``checkpoint``
        (a wire checkpoint from :meth:`stream_checkpoint`) opens BY
        RESTORE — the migration handoff's receiving half; model/rung
        ride inside the checkpoint and are ignored. ``wl`` carries
        the workload-family params for the ``wl-bank``/``wl-sets``
        session models (docs/workloads.md)."""
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq,
                     "kind": "stream", "verb": "open"}
        if checkpoint is not None:
            req["checkpoint"] = checkpoint
        if model is not None:
            req["model"] = model
        if keyed:
            req["keyed"] = True
        if rung is not None:
            req["rung"] = rung
        if wl is not None:
            req["wl"] = wl
        reply = self._request_shedding(req)
        return _checked(reply, raise_on_error)

    def stream_checkpoint(self, session: str, *,
                          release: bool = False,
                          raise_on_error: bool = True) -> dict:
        """Fetch a session's host-numpy checkpoint (wire form, in
        ``checkpoint``; ``checkpoint_bytes`` its size).
        ``release=True`` is the migration form: the daemon REMOVES
        the session (a handoff moves, never copies — two daemons
        serving one session would double-serve its appends)."""
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq,
                     "kind": "stream", "verb": "checkpoint",
                     "session": session}
        if release:
            req["release"] = True
        return _checked(self._request(req), raise_on_error)

    def drain(self, raise_on_error: bool = True) -> dict:
        """``kind:"drain"``: ask the daemon to leave gracefully —
        deregister, re-route queued work, finalize staged dispatches,
        serve session-checkpoint handoffs through its grace window,
        exit. The reply reports what was flushed/resident."""
        self._seq += 1
        return _checked(self._request({"op": "check", "kind": "drain",
                                       "id": self._seq}),
                        raise_on_error)

    def stream_append(self, session: str,
                      history: Union[str, List, None], *,
                      deadline_ms: Optional[int] = None,
                      raise_on_error: bool = True) -> dict:
        """Append one op delta; the reply is the verdict-so-far
        (``valid`` tri-state, ``checked_through``, per-append
        ``stages``). Once a session latches INVALID/UNKNOWN, appends
        answer immediately with ``latched: true``."""
        history = _as_edn(history)
        self._seq += 1
        req: dict = {"op": "check", "id": self._seq,
                     "kind": "stream", "verb": "append",
                     "session": session, "history": history}
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        reply = self._request_shedding(req)
        return _checked(reply, raise_on_error)

    def stream_poll(self, session: str,
                    raise_on_error: bool = True) -> dict:
        self._seq += 1
        reply = self._request({"op": "check", "id": self._seq,
                               "kind": "stream", "verb": "poll",
                               "session": session})
        return _checked(reply, raise_on_error)

    def stream_close(self, session: str,
                     raise_on_error: bool = True) -> dict:
        """Close: the tail settles (final verdict — bit-identical to
        a one-shot check of everything appended) and the carry frees."""
        self._seq += 1
        reply = self._request({"op": "check", "id": self._seq,
                               "kind": "stream", "verb": "close",
                               "session": session})
        return _checked(reply, raise_on_error)

    def status(self) -> dict:
        return self._request({"op": "status"})

    def metrics(self) -> dict:
        """Scrape the metrics plane (``kind:"metrics"``): one reply
        carrying both the JSON snapshot (``metrics``) and the
        Prometheus text form (``prometheus``)."""
        self._seq += 1
        return self._request({"op": "check", "kind": "metrics",
                              "id": self._seq})

    def ping(self) -> bool:
        try:
            return bool(self._request({"op": "ping"}).get("pong"))
        except OSError:
            return False

    def shutdown(self) -> bool:
        try:
            return bool(self._request({"op": "shutdown"}).get("bye"))
        except OSError:
            return False

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _hash64(data: bytes) -> int:
    """Stable 64-bit ring position (md5 prefix — NOT Python's
    ``hash``, which is salted per process and would re-shuffle the
    ring every restart)."""
    return int.from_bytes(hashlib.md5(data).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes: ``nodes_for(key)``
    yields every distinct node in ring order starting at the key's
    position — element 0 is the owner, the rest the failover chain.
    Pure data structure (unit-tested without sockets)."""

    def __init__(self, nodes, replicas: int = 64):
        if not nodes:
            raise ValueError("consistent-hash ring needs >= 1 node")
        self.nodes = sorted(set(nodes))
        self.replicas = replicas
        points = []
        for name in self.nodes:
            for v in range(replicas):
                points.append((_hash64(f"{name}#{v}".encode()), name))
        points.sort()
        self._points = points
        self._keys = [h for h, _ in points]

    def nodes_for(self, key: Union[str, bytes]) -> List[str]:
        if isinstance(key, str):
            key = key.encode()
        i = bisect_right(self._keys, _hash64(key)) % len(self._points)
        out, seen = [], set()
        for _, name in self._points[i:] + self._points[:i]:
            if name not in seen:
                seen.add(name)
                out.append(name)
        return out


class RoutedClient:
    """Consistent-hash routing over a fleet of verifier daemons.

    ``endpoints`` maps node name (the pmux service name, e.g.
    ``sut/verifier/0``) to an open :class:`ServiceClient`. Requests
    route by their SHAPE CLASS by default (kind | model | pow2 of the
    history size — everything the client can see of the daemon's
    shape bucket): same-class traffic coalesces on one daemon, so
    batch amortization survives routing, and the fleet PARTITIONS the
    compiled-program space + donated-carry pools instead of every
    daemon compiling every bucket (``route="payload"`` pins identical
    histories instead). Adding a daemon remaps only ~1/N of the
    classes. A node that fails (connect/IO after the client's own
    retry budget) fails over to the next distinct node on the ring;
    ``served`` counts per-node routed requests for placement
    audits."""

    def __init__(self, endpoints: Dict[str, ServiceClient],
                 replicas: int = 64, blacklist_ttl_s: float = 3.0,
                 epoch_poll_s: float = 1.0):
        if not endpoints:
            raise ValueError("RoutedClient needs >= 1 endpoint")
        self.clients = dict(endpoints)
        self.replicas = replicas
        self.ring = HashRing(list(endpoints), replicas=replicas)
        self.served: Dict[str, int] = {n: 0 for n in endpoints}
        self.failovers = 0
        self.refreshes = 0
        self.migrations = 0
        #: dead-node blacklist TTL: a node that failed a connect/IO
        #: is skipped on ring walks until the TTL expires, instead of
        #: paying a connect timeout on EVERY request that hashes near
        #: it; overload/drain replies park the node until the
        #: daemon's own retry_after_ms hint
        self.blacklist_ttl_s = float(blacklist_ttl_s)
        #: how often (at most) a routed call polls the single pmux
        #: epoch entry; failures force a poll immediately
        self.epoch_poll_s = float(epoch_poll_s)
        self._avoid: Dict[str, float] = {}   # node -> not-before
        self.epoch: Optional[int] = None     # ring version last seen
        self._epoch_checked = float("-inf")
        self._disco: Optional[tuple] = None  # (host, port, prefix, kw)
        #: a draining daemon deregisters FIRST and then serves session
        #: checkpoint handoffs on its ALREADY-OPEN connections only
        #: (the listener is closed) — so when a refresh drops a node
        #: that still has streams pinned to it, the warm client parks
        #: here instead of closing, or the O(carry) migration window
        #: would be destroyed by any unrelated routed request
        self._parting: Dict[str, ServiceClient] = {}
        self._pins: Dict[str, int] = {}      # node -> open streams

    @classmethod
    def discover(cls, pmux_port: int = 5105,
                 prefix: str = PMUX_SERVICE, host: str = "127.0.0.1",
                 **kw) -> "RoutedClient":
        """Build the fleet from ct_pmux: every registration named
        ``<prefix>`` or ``<prefix>/<shard>`` joins the ring (the
        ``--pmux-shard`` daemons). Raises when none is registered —
        an empty fleet is an operations failure, not an empty ring.
        The discovery parameters are retained: the client later
        REFRESHES the ring whenever the fleet's ring-version epoch
        bumps (a daemon joined or left), remapping ~1/N of the shape
        classes instead of ever serving from a stale membership."""
        from ..control.pmux import PmuxClient
        from .daemon import epoch_service_for

        # overload handling belongs to the ROUTED layer here: a node
        # answering overload is parked for its own retry_after_ms and
        # the walk moves on — the per-node client must not sleep-and-
        # re-dial the same overloaded daemon first (callers can still
        # opt back in explicitly)
        kw.setdefault("overload_retries", 0)
        with PmuxClient(host, pmux_port) as c:
            used = c.used()
        endpoints = {
            svc: ServiceClient(host, port, **kw)
            for svc, port in used.items()
            if svc == prefix or svc.startswith(prefix + "/")}
        if not endpoints:
            raise OSError(
                f"pmux at {host}:{pmux_port} knows no {prefix!r} "
                "daemons")
        rc = cls(endpoints)
        rc._disco = (host, pmux_port, prefix, dict(kw))
        rc.epoch = used.get(epoch_service_for(prefix))
        rc._epoch_checked = _monotonic()
        return rc

    # -- live membership (epochs) --------------------------------------

    def refresh(self) -> tuple:
        """Re-read the registry and rebuild the ring: new daemons
        join (their ~1/N of the classes remap onto them), departed
        ones leave (their classes remap onto survivors), surviving
        names keep their ServiceClient (warm connection). Returns
        ``(added, removed)`` name lists; a no-op without discovery
        parameters (statically-built clients)."""
        if self._disco is None:
            return [], []
        host, pmux_port, prefix, kw = self._disco
        from ..control.pmux import PmuxClient
        from .daemon import epoch_service_for

        with PmuxClient(host, pmux_port) as c:
            used = c.used()
        self.epoch = used.get(epoch_service_for(prefix))
        names = {svc: port for svc, port in used.items()
                 if svc == prefix or svc.startswith(prefix + "/")}
        if not names:
            # an empty registry mid-flight: keep serving on the
            # current ring — a stale ring beats no ring, and the
            # blacklist already shields dead nodes
            return [], []
        added = sorted(n for n in names if n not in self.clients)
        removed = sorted(n for n in self.clients if n not in names)
        for n in added:
            self.clients[n] = ServiceClient(host, names[n], **kw)
            self.served.setdefault(n, 0)
            self._avoid.pop(n, None)
        for n in removed:
            c = self.clients.pop(n)
            if self._pins.get(n):
                self._parting[n] = c     # pinned: see __init__ note
            else:
                c.close()
        repaired = 0
        for n, port in names.items():
            c = self.clients[n]
            if c.port != port:           # same name, restarted daemon
                c.close()
                c.port = port
                self._avoid.pop(n, None)
                repaired += 1
        self.ring = HashRing(list(self.clients),
                             replicas=self.replicas)
        if added or removed or repaired:
            self.refreshes += 1
        return added, removed

    def maybe_refresh(self, force: bool = False) -> bool:
        """Cheap membership check: ONE pmux ``get`` of the epoch
        entry, rate-limited to ``epoch_poll_s`` (every request pays a
        dict lookup, not a registry listing); a changed epoch
        triggers a full :meth:`refresh`. ``force`` skips the rate
        limit — failure paths call it so a dead/drained node is
        replaced on the spot."""
        if self._disco is None:
            return False
        now = _monotonic()
        if not force and now - self._epoch_checked < self.epoch_poll_s:
            return False
        self._epoch_checked = now
        host, pmux_port, prefix, _kw = self._disco
        from ..control.pmux import PmuxClient
        from .daemon import epoch_service_for

        try:
            with PmuxClient(host, pmux_port) as c:
                e = c.get(epoch_service_for(prefix))
        except OSError:
            return False
        if e is None or e == self.epoch:
            return False
        try:
            self.refresh()
        except OSError:
            return False
        # any epoch movement counts as "changed" for the caller's
        # retry decision: a refresh may have repaired a restarted
        # daemon's PORT without touching the name set, and the retry
        # must run against the repaired client either way
        return True

    # -- stream pins ---------------------------------------------------

    def _pin(self, name: str) -> None:
        self._pins[name] = self._pins.get(name, 0) + 1

    def _unpin(self, name: str) -> None:
        n = self._pins.get(name, 0) - 1
        if n > 0:
            self._pins[name] = n
            return
        self._pins.pop(name, None)
        c = self._parting.pop(name, None)
        if c is not None:
            c.close()

    # -- the ring walk -------------------------------------------------

    def _route(self, key: Union[str, bytes], fn, _retry: bool = True):
        """Walk the ring from the key's owner: blacklisted nodes
        (dead within TTL, overloaded within their own retry_after_ms
        hint, draining) are skipped — never re-dialed hot; a node
        that fails here is parked and the walk continues. When the
        whole walk fails, one forced membership refresh retries the
        walk once (the fleet may have changed under us)."""
        self.maybe_refresh()
        now = _monotonic()
        chain = self.ring.nodes_for(key)
        live = [n for n in chain if self._avoid.get(n, 0.0) <= now]
        last: Optional[Exception] = None
        for name in (live or chain):
            # all-parked falls through to the raw chain: trying a
            # blacklisted node beats refusing the request outright
            c = self.clients.get(name)
            if c is None:
                continue
            try:
                out = fn(c)
            except OSError as e:
                last = e
                self.failovers += 1
                # timestamp AFTER the failure: a hung connect burns
                # its timeout before raising, and a TTL anchored at
                # walk start would already be expired when written
                self._avoid[name] = _monotonic() + self.blacklist_ttl_s
                continue
            except ServiceError as e:
                if e.code == protocol.OVERLOAD:
                    # honor the node's own backpressure hint during
                    # failover: park it for retry_after_ms and try
                    # the next ring node (only the happy path backed
                    # off before)
                    ra = e.retry_after_ms
                    if not isinstance(ra, (int, float)) or ra <= 0:
                        ra = 100.0
                    self._avoid[name] = _monotonic() + float(ra) / 1e3
                    self.failovers += 1
                    last = e
                    continue
                if e.code == protocol.SHUTDOWN:
                    # draining daemon: it already deregistered AND
                    # bumped the epoch before this reply — park it
                    # and force the membership check now, restarting
                    # the walk on the refreshed ring instead of
                    # burning a hop on it per walk until the poll
                    self._avoid[name] = (_monotonic()
                                         + self.blacklist_ttl_s)
                    self.failovers += 1
                    last = e
                    if _retry and self.maybe_refresh(force=True):
                        return self._route(key, fn, _retry=False)
                    continue
                raise
            self.served[name] += 1
            return out
        if _retry and self.maybe_refresh(force=True):
            return self._route(key, fn, _retry=False)
        if isinstance(last, ServiceError):
            raise last
        raise OSError(f"every daemon on the ring failed: {last}")

    @staticmethod
    def route_key(history: str, kind: str = "check",
                  model: Optional[str] = None,
                  route: str = "shape") -> str:
        """The ring key for one request. ``"shape"`` (default) is the
        client-visible shape class — kind, model, and the pow2 size
        class of the EDN payload — so a daemon owns whole bucket
        classes; ``"payload"`` hashes the full history (identical
        histories pin, every bucket scatters across the fleet)."""
        if route == "payload":
            return f"{kind}|{model or ''}|{history}"
        size = max(len(history), 1)
        return f"{kind}|{model or ''}|{1 << (size - 1).bit_length()}"

    def check(self, history: Union[str, List, None] = None, *,
              route: str = "shape", **kw) -> dict:
        history = _as_edn(history)
        key = self.route_key(history, "txn" if kw.get("txn")
                             else "check", kw.get("model"), route)
        return self._route(key, lambda c: c.check(history, **kw))

    def shrink(self, history: Union[str, List, None] = None, *,
               route: str = "shape", **kw) -> dict:
        history = _as_edn(history)
        key = self.route_key(history, "shrink", kw.get("model"),
                             route)
        return self._route(key, lambda c: c.shrink(history, **kw))

    def check_wl(self, history: Union[str, List, None], family: str,
                 *, route: str = "shape", **kw) -> dict:
        """Route one workload-family check: the family IS the
        client-visible shape class root, so one daemon owns each
        family's bucket ladder and batch amortization survives
        routing (docs/workloads.md)."""
        history = _as_edn(history)
        key = self.route_key(history, "wl", family, route)
        return self._route(key,
                           lambda c: c.check_wl(history, family, **kw))

    def stream_open(self, *, model: Optional[str] = None,
                    keyed: bool = False, rung: Optional[str] = None,
                    wl: Optional[dict] = None) -> "RoutedStream":
        """Open a session with AFFINITY: the session id pins every
        later verb to the daemon holding the carry (routing an append
        elsewhere would find no session — a carry is not portable
        over the wire). Failover is replay: when the pinned daemon
        dies (or evicted the session), the handle re-opens on the
        next ring node and replays its retained deltas, then resumes
        — the client-side mirror of the daemon's retained columnar
        tables (docs/streaming.md "Failover")."""
        return RoutedStream(self, model=model, keyed=keyed, rung=rung,
                            wl=wl)

    def statuses(self) -> Dict[str, dict]:
        """Per-daemon status (skipping unreachable nodes)."""
        out = {}
        for name, c in self.clients.items():
            try:
                out[name] = c.status()["status"]
            except OSError:
                pass
        return out

    def ping_all(self) -> Dict[str, bool]:
        return {name: c.ping() for name, c in self.clients.items()}

    def close(self) -> None:
        for c in self.clients.values():
            c.close()
        for c in self._parting.values():
            c.close()
        self._parting.clear()

    def __enter__(self) -> "RoutedClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RoutedStream:
    """One streaming session pinned to its daemon (see
    :meth:`RoutedClient.stream_open`). Retains every appended delta's
    EDN so a node failure (or idle eviction) re-opens on the next
    ring node and REPLAYS — the final verdict is unchanged because a
    session's verdict is a pure function of the concatenated ops."""

    def __init__(self, routed: RoutedClient,
                 model: Optional[str] = None, keyed: bool = False,
                 rung: Optional[str] = None,
                 wl: Optional[dict] = None):
        self.routed = routed
        self.model = model
        self.keyed = keyed
        self.rung = rung
        self.wl = wl
        self._deltas: List[str] = []
        self.failovers = 0
        self.migrations = 0
        self.node: Optional[str] = None
        self.session: Optional[str] = None
        self._closed = False
        self._open_somewhere(
            routed.ring.nodes_for(f"stream|{model or ''}|"
                                  f"{id(self):x}"))

    def _client(self) -> ServiceClient:
        # prefer the PARTING table: a draining daemon is reachable
        # only over this retained warm connection (its listener is
        # closed), and if the same shard name has re-registered, the
        # fresh client in ``clients`` is a NEW process that does not
        # hold this session's carry
        c = (self.routed._parting.get(self.node)
             or self.routed.clients.get(self.node))
        if c is None:
            # the pinned daemon left the ring under a refresh
            raise OSError(f"session node {self.node!r} left the ring")
        return c

    def _open_somewhere(self, chain,
                        checkpoint: Optional[dict] = None) -> None:
        last: Optional[Exception] = None
        for name in chain:
            c = self.routed.clients.get(name)
            if c is None:
                continue
            try:
                r = c.stream_open(model=self.model, keyed=self.keyed,
                                  rung=self.rung, wl=self.wl,
                                  checkpoint=checkpoint)
                if self.node is not None:
                    self.routed._unpin(self.node)
                self.routed._pin(name)
                self.node = name
                self.session = r["session"]
                self.routed.served[name] = \
                    self.routed.served.get(name, 0) + 1
                return
            except (OSError, ServiceError) as e:
                last = e
        raise OSError(f"no daemon would open a stream session: {last}")

    def _migrate(self) -> bool:
        """The drain/leave handoff (docs/streaming.md "Checkpoint /
        migration"): fetch-AND-RELEASE the session's checkpoint from
        the departing daemon, re-open from it on the next ring node —
        O(carry) over the wire, zero device replay, dispatch count
        stays O(delta) afterward. Returns False when the old daemon
        can't serve the handoff (already dead) — the caller then
        falls back to retained-delta replay."""
        old = self.node
        try:
            r = self._client().stream_checkpoint(
                self.session, release=True, raise_on_error=False)
        except OSError:
            return False
        ck = r.get("checkpoint") if r.get("ok") else None
        if ck is None:
            return False
        self.routed.maybe_refresh(force=True)
        chain = [n for n in self.routed.ring.nodes_for(
            f"stream|{self.model or ''}|{id(self):x}")
            if n != old] or [n for n in self.routed.clients
                             if n != old]
        try:
            self._open_somewhere(chain, checkpoint=ck)
        except OSError:
            return False
        self.migrations += 1
        self.routed.migrations += 1
        return True

    def _failover(self) -> None:
        self.failovers += 1
        self.routed.failovers += 1
        self.routed.maybe_refresh(force=True)
        chain = [n for n in self.routed.ring.nodes_for(
            f"stream|{self.model or ''}|{id(self):x}")
            if n != self.node] or list(self.routed.clients)
        self._open_somewhere(chain)
        # replay the retained deltas ONE BY ONE in order: each delta
        # is a self-contained EDN document (vector-of-maps deltas
        # would mis-parse if concatenated into one text), and each
        # replay append is O(delta) anyway. A replay failure must
        # surface — continuing would silently verify a history with
        # the retained prefix missing.
        for d in self._deltas:
            r = self.routed.clients[self.node].stream_append(
                self.session, d, raise_on_error=False)
            if not r.get("ok"):
                raise OSError(
                    f"failover replay failed on {self.node}: {r}")

    def _pinned(self, fn, retried: bool = False):
        try:
            return fn(self._client())
        except OSError:
            if retried:
                raise
            self._failover()
            return self._pinned(fn, retried=True)

    def append(self, history: Union[str, List], **kw) -> dict:
        text = _as_edn(history)
        out = self._pinned(
            lambda c: c.stream_append(self.session, text,
                                      raise_on_error=False, **kw))
        if (not out.get("ok")
                and out.get("error") == protocol.SHUTDOWN):
            # the pinned daemon is draining: hand the session off by
            # checkpoint (O(carry)); only a daemon too dead to serve
            # the handoff costs the full retained-delta replay
            if not self._migrate():
                self._failover()
            out = self._pinned(
                lambda c: c.stream_append(self.session, text,
                                          raise_on_error=False, **kw))
        if (not out.get("ok")
                and out.get("error") == protocol.BAD_REQUEST
                and "unknown session" in out.get("message", "")):
            # aged fully out (checkpoint bound) on a live daemon:
            # same replay path as a dead node
            self._failover()
            out = self._pinned(
                lambda c: c.stream_append(self.session, text,
                                          raise_on_error=False, **kw))
        if out.get("ok") and out.get("cause") != "deadline":
            # a deadline expiry answers ok with cause="deadline" and
            # the delta was NEVER ingested (core._expire_one) — it
            # must not join the replay record as applied; the caller
            # sees the cause and may re-append the same delta
            self._deltas.append(text)
        return out

    def poll(self) -> dict:
        return self._pinned(
            lambda c: c.stream_poll(self.session,
                                    raise_on_error=False))

    def close(self) -> dict:
        try:
            out = self._pinned(
                lambda c: c.stream_close(self.session,
                                         raise_on_error=False))
        finally:
            # unpin even when the close request itself fails (dead
            # daemon, failover exhausted) — a leaked pin would park
            # the node's client in _parting forever on the next
            # refresh, with no remaining path that closes it
            self._deltas = []
            if not self._closed and self.node is not None:
                self.routed._unpin(self.node)
                self._closed = True
        return out


def _as_edn(history) -> str:
    if isinstance(history, str):
        return history
    from ..ops.history import history_to_edn

    return history_to_edn(list(history or []))


__all__ = ["HashRing", "RoutedClient", "RoutedStream",
           "ServiceClient", "ServiceError"]
