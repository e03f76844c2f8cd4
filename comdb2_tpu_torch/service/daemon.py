"""The verifier daemon — a single-threaded selector loop over
:class:`~.core.VerifierCore` (the counterpart of the JAX package's
``service/daemon.py``).

Continuous-batching loop: every selector round pumps the
core — requests slot into their buckets as the bytes arrive, a full
batch launches inside ``submit`` itself, and the pump launches
whatever bucket's launch budget came due. A quiet round (no bytes)
pumps with ``idle=True``: every forming batch launches and the
in-flight ring drains, so a lone serial caller is answered
immediately instead of paying the fill window. Device dispatches are
STAGED on this thread and finalize through the core's bounded ring —
the overlap is host-pack vs the card's queued launches (never
multiprocessing).

Discovery: with ``--pmux``, the daemon publishes its port under
``sut/verifier`` (or ``sut/verifier/<shard>`` for a horizontally
scaled fleet — ``--pmux-shard``) through the same ``ct_pmux`` path
the native SUT uses (``control/pmux.py``); clients then resolve the
service by name, and :class:`~.client.RoutedClient` consistent-hash
routes over every registered daemon.

Observability: ``{"op": "status"}`` returns the status JSON on the
same socket and ``{"op": "metrics"}`` (or ``kind:"metrics"`` on the
check op) scrapes the metrics plane (Prometheus text + JSON forms —
docs/observability.md); with ``--store`` the status snapshot is
persisted through :func:`comdb2_tpu_torch.harness.store.
save_service_status` on every artifact interval and at shutdown,
alongside ``timeline.svg`` (the per-request stage latencies and event
marks of :meth:`~.core.VerifierCore.timeline_records`, rendered by
:func:`comdb2_tpu_torch.report.service_svg.render_service_timeline`)
and — with ``--trace`` — ``trace.json`` (Chrome/Perfetto span export).
"""

from __future__ import annotations

import logging
import os
import selectors
import socket
from typing import Dict, Optional

from ..obs import trace as obs
from . import protocol
from .core import VerifierCore

logger = logging.getLogger(__name__)

PMUX_SERVICE = "sut/verifier"


def epoch_service_for(service: str) -> str:
    """The fleet's ring-version entry in pmux, derived from a daemon's
    service name: ``sut/verifier`` and every ``sut/verifier/<shard>``
    share ``sut/verifier.epoch``. A ``.``-suffixed sibling on purpose —
    ``RoutedClient.discover`` matches ``<prefix>`` or ``<prefix>/...``,
    so the epoch entry never masquerades as a daemon endpoint."""
    base, sep, tail = service.rpartition("/")
    if sep and tail.isdigit():
        service = base
    return service + ".epoch"


def bump_ring_epoch(pmux, service: str) -> int:
    """Read-increment-publish the ring version (every membership
    change — join, leave, drain, crash cleanup — bumps it; clients
    poll the single entry instead of re-listing the registry). The
    RMW is unlocked: concurrent bumps may collapse into one, which is
    fine — clients only need the value to CHANGE, and a refresh reads
    the full registry anyway."""
    svc = epoch_service_for(service)
    cur = int(pmux.get(svc) or 0)
    # pmux rejects a value already published as another service's
    # PORT (epoch rides the port slot of its entry) — skip over
    # collisions; any strictly larger value is a valid bump
    for nxt in range(cur + 1, cur + 17):
        try:
            pmux.use(svc, nxt)
            return nxt
        except OSError:
            continue
    raise OSError(f"could not bump {svc} past {cur}")


class _Conn:
    __slots__ = ("sock", "addr", "rbuf")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.rbuf = b""


class VerifierDaemon:
    """One listening socket, N client connections, one tick loop."""

    def __init__(self, core: VerifierCore, host: str = "127.0.0.1",
                 port: int = 0, coalesce_s: Optional[float] = None,
                 pmux_port: Optional[int] = None,
                 pmux_service: str = PMUX_SERVICE,
                 store_root: Optional[str] = None,
                 artifact_interval_s: float = 30.0,
                 drain_grace_s: float = 10.0):
        self.core = core
        if coalesce_s is not None:
            # legacy knob: the coalesce window is now the core's
            # per-bucket fill window (a cap on batch formation, not a
            # tick round)
            core.fill_window_s = max(float(coalesce_s), 0.0)
        self.pmux_port = pmux_port
        self.pmux_service = pmux_service
        self.store_root = store_root
        self.artifact_interval_s = artifact_interval_s
        #: after drain entry, how long to keep serving session
        #: handoffs (checkpoint fetches) before closing anyway
        self.drain_grace_s = float(drain_grace_s)
        self._stop = False
        self._draining = False
        self._drain_req = False
        self._drain_deadline = 0.0
        self._published = False
        self._dropped_replies = 0
        self._sel = selectors.DefaultSelector()
        self._conns: Dict[int, _Conn] = {}
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(128)
        lsock.setblocking(False)
        self._lsock = lsock
        self.host, self.port = lsock.getsockname()
        self._sel.register(lsock, selectors.EVENT_READ, None)

    # -- lifecycle -----------------------------------------------------

    @property
    def published(self) -> bool:
        """Whether the pmux registration actually happened (the ready
        line reports ``pmux_service`` null when it did not)."""
        return self._published

    def stop(self, *_args) -> None:
        self._stop = True

    def drain(self, *_args) -> None:
        """Request a graceful leave (SIGTERM lands here): deregister
        from pmux and bump the ring epoch BEFORE anything closes,
        re-route queued work, finalize staged dispatches, keep serving
        session-checkpoint handoffs for ``drain_grace_s``, then exit.
        Signal-safe — only sets a flag; the run loop does the work."""
        self._drain_req = True

    def run(self) -> None:
        self._pmux_publish()
        last_artifact = obs.monotonic()
        try:
            while not self._stop:
                timeout = self._select_timeout()
                got_bytes = self._pump(timeout)
                now = obs.monotonic()
                if (self._drain_req or self.core.draining) \
                        and not self._draining:
                    self._begin_drain(now)
                # the scheduler beat: launch due buckets; on a quiet
                # round (no new bytes) launch everything forming and
                # drain the in-flight ring — serial callers never
                # wait out the fill window
                for p, reply in self.core.pump(now,
                                               idle=not got_bytes):
                    self._send(p.ctx, reply)
                if self._draining and self.core.drained() and \
                        ((len(self.core.sessions) == 0
                          and self.core.sessions.checkpoint_count()
                          == 0)
                         or now >= self._drain_deadline):
                    # idle-EVICTED sessions hold the daemon through
                    # the grace too: their host checkpoints are what
                    # the handoff serves — exiting on resident==0
                    # alone would discard them and cost the client a
                    # full retained-delta replay
                    self._stop = True
                if self.store_root is not None and \
                        now - last_artifact >= self.artifact_interval_s:
                    self._save_artifact()
                    last_artifact = now
        finally:
            self._shutdown()

    def _begin_drain(self, now: float) -> None:
        """Drain entry ordering is the whole contract (the stale-
        registration bug): DEREGISTER (+ epoch bump) first — so no
        client routes new work here — then stop accepting connections,
        then re-route the queued work. The listener closes while
        existing connections stay open: clients must be able to fetch
        their sessions' checkpoints through the grace window."""
        self._draining = True
        self._drain_deadline = now + self.drain_grace_s
        self._pmux_withdraw()
        try:
            self._sel.unregister(self._lsock)
        except (KeyError, ValueError):
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self.core.begin_drain(now)
        logger.info("draining: grace %.1fs, %d session(s) resident",
                    self.drain_grace_s, len(self.core.sessions))

    #: with work queued (forming batches, host/shrink work, staged
    #: dispatches), select() sleeps at most this long — the pump then
    #: sees either new bytes (keep filling) or a quiet round (launch +
    #: drain)
    IDLE_PROBE_S = 0.001

    def _select_timeout(self) -> Optional[float]:
        if self.core.queue_depth() or self.core.inflight():
            nxt = self.core.next_event_at()
            if nxt is not None:
                return min(max(nxt - obs.monotonic(), 0.0),
                           self.IDLE_PROBE_S)
            return self.IDLE_PROBE_S
        return 0.5

    # -- socket plumbing -----------------------------------------------

    def _pump(self, timeout: Optional[float]) -> bool:
        """One select round; returns whether any payload arrived."""
        got = False
        for key, _ in self._sel.select(timeout):
            if key.data is None:
                self._accept()
                continue
            got |= self._read(key.data)
        return got

    def _accept(self) -> None:
        try:
            sock, addr = self._lsock.accept()
        except OSError:
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock, addr)
        self._conns[sock.fileno()] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _read(self, conn: _Conn) -> bool:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            self._close(conn)
            return False
        if not data:
            self._close(conn)
            return False
        conn.rbuf += data
        while b"\n" in conn.rbuf:
            line, conn.rbuf = conn.rbuf.split(b"\n", 1)
            if line.strip():
                self._handle(conn, line)
        return True

    def _close(self, conn: _Conn) -> None:
        """A client vanished — mid-request is fine: its pending reply
        is dropped at send time, the batch runs regardless."""
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn.sock.fileno(), None)
        try:
            conn.sock.close()
        except OSError:
            pass

    #: per-reply send bound: client sockets are non-blocking for the
    #: selector reads, and sendall() on a non-blocking socket raises
    #: BlockingIOError the moment the kernel buffer fills (a pipelined
    #: client slow to read) — a live client's replies would be dropped
    #: mid-stream. A temporary timeout makes the send blocking-with-
    #: bound instead; a client that can't drain a small reply within
    #: it is treated as gone.
    SEND_TIMEOUT_S = 5.0

    def _send(self, conn: Optional[_Conn], obj: dict) -> None:
        if conn is None or conn.sock.fileno() < 0:
            self._dropped_replies += 1
            return
        try:
            conn.sock.settimeout(self.SEND_TIMEOUT_S)
            try:
                conn.sock.sendall(protocol.encode(obj))
            finally:
                conn.sock.settimeout(0)     # back to non-blocking
        except OSError:
            self._dropped_replies += 1
            self._close(conn)

    # -- requests ------------------------------------------------------

    def _handle(self, conn: _Conn, line: bytes) -> None:
        try:
            req = protocol.decode(line)
        except ValueError as e:
            self._send(conn, protocol.error_reply(
                protocol.BAD_REQUEST, str(e)))
            return
        op = req.get("op")
        now = obs.monotonic()
        if op == "check":
            try:
                pending, reply = self.core.submit(req, now, ctx=conn)
            except Exception as e:          # noqa: BLE001 — client data
                # belt-and-braces: a request that slips past submit's
                # validation must never tear down the shared daemon
                reply = protocol.error_reply(
                    protocol.BAD_REQUEST,
                    f"{type(e).__name__}: {e}", req.get("id"))
            if reply is not None:
                self._send(conn, reply)
            return
        rid = req.get("id")
        if op == "status":
            st = self.core.status(now)
            st["dropped_replies"] = self._dropped_replies
            st["connections"] = len(self._conns)
            out = {"ok": True, "status": st}
            if rid is not None:
                out["id"] = rid
            self._send(conn, out)
        elif op == "metrics":
            # alias of kind:"metrics" — same reply, scrape-friendly
            self._send(conn, self.core.metrics_reply(rid))
        elif op == "ping":
            self._send(conn, {"ok": True, "pong": True,
                              **({"id": rid} if rid is not None
                                 else {})})
        elif op == "shutdown":
            self._send(conn, {"ok": True, "bye": True,
                              **({"id": rid} if rid is not None
                                 else {})})
            self._stop = True
        else:
            self._send(conn, protocol.error_reply(
                protocol.BAD_REQUEST, f"unknown op {op!r}", rid))

    # -- discovery / artifacts -----------------------------------------

    def _pmux_publish(self) -> None:
        """Idempotent: ``__main__`` publishes BEFORE printing the
        ready line (ready must mean discoverable — a fleet booter
        races discovery against it), ``run()`` keeps the call for
        embedders driving the daemon directly."""
        if self.pmux_port is None or self._published:
            return
        from ..control.pmux import PmuxClient

        try:
            with PmuxClient(port=self.pmux_port) as c:
                c.use(self.pmux_service, self.port)
                # the registration is LIVE from here: mark published
                # BEFORE the epoch bump, or a bump failure would
                # leave _published False and _pmux_withdraw would
                # never delete the live entry — a permanently stale
                # registration, the exact bug drain ordering fixes
                self._published = True
                # a join is a membership change: bump the ring
                # version so RoutedClients refresh (~1/N of the
                # shape classes remap onto this daemon)
                self.core.ring_epoch = bump_ring_epoch(
                    c, self.pmux_service)
            logger.info("published %s -> %d via pmux:%d (epoch %d)",
                        self.pmux_service, self.port, self.pmux_port,
                        self.core.ring_epoch)
        except OSError as e:
            # discovery is additive; a dead pmux must not stop serving
            logger.warning("pmux %s failed: %s",
                           "epoch bump" if self._published
                           else "registration", e)

    def _pmux_withdraw(self) -> None:
        """Deregister + bump the ring epoch — the leave-side
        membership change. Idempotent (drain runs it early; shutdown
        runs it again)."""
        if self.pmux_port is None or not self._published:
            return
        self._published = False
        from ..control.pmux import PmuxClient

        try:
            with PmuxClient(port=self.pmux_port) as c:
                c.delete(self.pmux_service)
                self.core.ring_epoch = bump_ring_epoch(
                    c, self.pmux_service)
        except OSError:
            pass

    def _save_artifact(self) -> None:
        from ..harness.store import save_service_status

        try:
            save_service_status(self.core.status(),
                                store_root=self.store_root)
        except OSError as e:
            logger.warning("service artifact write failed: %s", e)
        self._save_obs()

    def _save_obs(self) -> None:
        """The observability artifacts next to the status snapshot:
        ``trace.json`` (Chrome/Perfetto trace-event export — only
        when tracing is enabled) and ``timeline.svg`` (the per-run
        latency/rate timeline), both under ``<store>/service/`` where
        the store web index links them."""
        d = os.path.join(self.store_root, "service")
        try:
            os.makedirs(d, exist_ok=True)
            if obs.enabled():
                obs.export_chrome(os.path.join(d, "trace.json"))
            records, events = self.core.timeline_records()
            if records:
                from ..report.service_svg import \
                    render_service_timeline

                render_service_timeline(
                    records, events,
                    path=os.path.join(d, "timeline.svg"))
        except OSError as e:
            logger.warning("obs artifact write failed: %s", e)

    def _shutdown(self) -> None:
        """Answer nothing new, flush queued requests as unknown, close
        every socket — a clean exit, never a hang with clients blocked
        on reads."""
        # withdraw FIRST: clients re-route on the epoch bump, so the
        # ring must stop advertising this node before its listener
        # starts refusing connects (rule deregister-before-close)
        self._pmux_withdraw()
        for p, reply in self.core.tick(obs.monotonic()):
            self._send(p.ctx, reply)
        for conn in list(self._conns.values()):
            self._close(conn)
        try:
            self._sel.unregister(self._lsock)
        except (KeyError, ValueError):
            pass
        self._lsock.close()
        self._sel.close()
        if self.store_root is not None:
            self._save_artifact()


__all__ = ["PMUX_SERVICE", "VerifierDaemon", "bump_ring_epoch",
           "epoch_service_for"]
