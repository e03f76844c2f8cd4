"""Fleet supervisor — spawn/retire verifier daemons from scrape data.

``python -m comdb2_tpu_torch.service.supervisor`` keeps an elastic fleet of
pmux-registered daemons alive and right-sized (docs/service.md
"Elastic fleet"):

- **spawn**: each daemon registers as ``sut/verifier/<shard>`` and
  bumps the fleet's ring epoch — ``RoutedClient``s refresh and ~1/N
  of the shape classes remap onto the newcomer.
- **retire**: the supervisor sends ``kind:"drain"`` (the daemon
  deregisters first, re-routes queued work, finalizes staged
  dispatches, serves session-checkpoint handoffs through its grace
  window), escalates to SIGTERM (the same drain path), and only then
  SIGKILL — and always ``wait()``s the child: a host without an init
  reaper keeps an unreaped daemon as a zombie.
- **autoscale**: the sizing signal is the scrape — fleet queue depth
  and completion (drain) rate as EWMAs, plus resident streaming
  sessions. :func:`desired_count` is the pure policy (unit-tested
  without sockets): scale up when the backlog's drain time exceeds
  ``up_backlog_s`` or the session tables near their cap, down when
  it undershoots ``down_backlog_s`` with session headroom.
- **crash cleanup**: a daemon that dies without draining (SIGKILL,
  OOM) left its pmux registration behind — clients would keep
  routing to it until a connect error. The supervisor deletes the
  stale entry, bumps the epoch, and respawns per policy.

Everything runs on one thread; the beat is a
poll loop, not a subprocess-per-metric scraper.
"""

from __future__ import annotations

import json
import logging
import os
import select
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..obs.trace import monotonic as _monotonic
from .daemon import PMUX_SERVICE, bump_ring_epoch

logger = logging.getLogger(__name__)


def desired_count(n: int, depth_ewma: float, drain_rate_ewma: float,
                  sessions: int, *, min_daemons: int = 1,
                  max_daemons: int = 4, up_backlog_s: float = 2.0,
                  down_backlog_s: float = 0.2,
                  session_headroom: float = 0.75,
                  max_sessions: int = 64) -> int:
    """The sizing policy, pure and unit-testable. ``depth_ewma`` is
    the fleet-wide admission queue depth, ``drain_rate_ewma`` the
    fleet completion rate (req/s), ``sessions`` the resident
    streaming sessions. Backlog seconds = depth / rate — the time the
    current queue needs to drain at the observed rate (the same
    quantity behind the daemon's ``retry_after_ms`` hint). One step
    at a time: the beat re-evaluates, so ramps converge without
    flapping."""
    rate = max(drain_rate_ewma, 1e-6)
    backlog_s = depth_ewma / rate if depth_ewma > 0 else 0.0
    cap = max(int(session_headroom * max_sessions * n), 1)
    if n < max_daemons and (backlog_s > up_backlog_s
                            or sessions >= cap):
        return n + 1
    if n > min_daemons and backlog_s < down_backlog_s \
            and sessions < int(session_headroom * max_sessions
                               * (n - 1)):
        return n - 1
    return n


def stderr_tail(path: Optional[str], n_bytes: int = 4000) -> str:
    """The last ``n_bytes`` of a child's standard-error file, as a
    suffix for a report (empty without a file)."""
    if path is None:
        return ""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(fh.tell() - n_bytes, 0))
            tail = fh.read().decode("utf-8", "replace").strip()
    except OSError as e:
        return f"; its stderr ({path}) is unreadable: {e}"
    return f"; its stderr ({path}):\n{tail}" if tail else \
        f"; its stderr ({path}) is empty"


def _client(port: int, timeout_s: float = 5.0):
    """One-shot daemon client (retries=0: the beat handles dead
    children itself — reuse the ONE wire implementation instead of a
    third hand-rolled socket path)."""
    from .client import ServiceClient

    return ServiceClient("127.0.0.1", port, timeout_s=timeout_s,
                         retries=0)


@dataclass
class Child:
    shard: int
    proc: subprocess.Popen
    port: int
    service: str
    t_spawn: float
    last_completed: int = 0
    stats: dict = field(default_factory=dict)
    stderr_path: Optional[str] = None


class Supervisor:
    """See module docstring. Drive :meth:`beat` yourself (tests) or
    :meth:`run` for the CLI loop."""

    def __init__(self, pmux_port: Optional[int] = None,
                 min_daemons: int = 1, max_daemons: int = 4,
                 daemon_args: Sequence[str] = (),
                 poll_s: float = 1.0,
                 drain_grace_s: float = 10.0,
                 scale_cooldown_s: float = 5.0,
                 up_backlog_s: float = 2.0,
                 down_backlog_s: float = 0.2,
                 max_sessions: int = 64,
                 ewma_alpha: float = 0.3,
                 spawn_timeout_s: float = 180.0,
                 prefix: str = PMUX_SERVICE,
                 stderr_dir: Optional[str] = None):
        self.pmux_port = pmux_port
        self.min_daemons = int(min_daemons)
        self.max_daemons = int(max_daemons)
        self.daemon_args = list(daemon_args)
        self.poll_s = float(poll_s)
        self.drain_grace_s = float(drain_grace_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.up_backlog_s = float(up_backlog_s)
        self.down_backlog_s = float(down_backlog_s)
        self.max_sessions = int(max_sessions)
        self.ewma_alpha = float(ewma_alpha)
        #: cap on the wait for a child's ready line (generous: boot
        #: builds the kernel libraries and primes them, and a cold
        #: ``nvcc`` build takes seconds); without it one wedged child blocks the whole
        #: single-threaded beat, so nothing gets reaped or refilled
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.prefix = prefix
        #: where each child's standard error goes, one file per spawn
        #: (``daemon-<shard>.err``); a child that dies, before or after
        #: its ready line, is reported with the file's tail. None
        #: discards it
        self.stderr_dir = stderr_dir
        self.children: Dict[int, Child] = {}
        self._next_shard = 0
        self._stop = False
        self._t_scaled = float("-inf")
        self._t_last_beat: Optional[float] = None
        self.depth_ewma = 0.0
        self.drain_rate_ewma = 0.0
        # counters for status/tests
        self.spawned = 0
        self.retired = 0
        self.deaths = 0
        self.stale_cleanups = 0

    # -- lifecycle -----------------------------------------------------

    def spawn(self) -> Child:
        """Start one daemon on the next shard index and wait for its
        ready line (ready means pmux-registered — the epoch already
        bumped, clients already see it)."""
        shard = self._next_shard
        self._next_shard += 1
        service = f"{self.prefix}/{shard}"
        cmd = [sys.executable, "-m", "comdb2_tpu_torch.service",
               "--port", "0", "--drain-s", str(self.drain_grace_s),
               *self.daemon_args]
        if self.pmux_port is not None:
            cmd += ["--pmux", str(self.pmux_port),
                    "--pmux-shard", str(shard)]
        err_path = None
        err = subprocess.DEVNULL
        if self.stderr_dir is not None:
            os.makedirs(self.stderr_dir, exist_ok=True)
            err_path = os.path.join(self.stderr_dir,
                                    f"daemon-{shard}.err")
            err = open(err_path, "wb")
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=err, text=True,
                env=dict(os.environ))
        finally:
            if err_path is not None:
                err.close()
        ready_fds, _, _ = select.select([proc.stdout], [], [],
                                        self.spawn_timeout_s)
        if not ready_fds:
            proc.kill()
            proc.wait(timeout=30)
            raise OSError(f"daemon {shard} produced no ready line "
                          f"within {self.spawn_timeout_s:.0f}s"
                          + stderr_tail(err_path))
        line = proc.stdout.readline()
        try:
            ready = json.loads(line)
        except json.JSONDecodeError:
            proc.kill()
            proc.wait(timeout=30)
            raise OSError(f"daemon {shard} never became ready: "
                          f"{line!r}" + stderr_tail(err_path))
        if not ready.get("ready"):
            proc.kill()
            proc.wait(timeout=30)
            raise OSError(f"daemon {shard} not ready: {ready}"
                          + stderr_tail(err_path))
        child = Child(shard=shard, proc=proc, port=ready["port"],
                      service=service, t_spawn=_monotonic(),
                      stderr_path=err_path)
        self.children[shard] = child
        self.spawned += 1
        logger.info("spawned %s on port %d (pid %d)", service,
                    child.port, proc.pid)
        return child

    def retire(self, shard: int) -> None:
        """Drain-then-stop one daemon, and ALWAYS reap it: drain verb
        (graceful leave — deregistration, re-routes, checkpoint
        handoffs), SIGTERM escalation (same drain path in-process),
        SIGKILL as the last resort. ``wait()`` runs in every branch —
        a retired child must never outlive this call as a zombie."""
        child = self.children.pop(shard, None)
        if child is None:
            return
        try:
            with _client(child.port) as c:
                c.drain(raise_on_error=False)
        except (OSError, ValueError):
            pass
        try:
            child.proc.wait(timeout=self.drain_grace_s + 5.0)
        except subprocess.TimeoutExpired:
            child.proc.terminate()          # SIGTERM: the drain path
            try:
                child.proc.wait(timeout=self.drain_grace_s + 5.0)
            except subprocess.TimeoutExpired:
                child.proc.kill()
                child.proc.wait(timeout=30)
        self.retired += 1
        if child.proc.returncode not in (0, -signal.SIGKILL):
            logger.warning("%s exited %s%s", child.service,
                           child.proc.returncode,
                           stderr_tail(child.stderr_path))

    def shutdown(self) -> None:
        """Retire everything (largest shard first) and reap."""
        for shard in sorted(self.children, reverse=True):
            self.retire(shard)

    # -- the beat ------------------------------------------------------

    def _reap_and_respawn(self) -> None:
        """A child that died on its own (crash, SIGKILL nemesis) is
        reaped here (``poll()`` collects the zombie), its stale pmux
        registration deleted (+ epoch bump — clients must stop
        routing to a corpse), and the fleet refilled to the floor."""
        for shard, child in list(self.children.items()):
            if child.proc.poll() is None:
                continue
            self.children.pop(shard)
            self.deaths += 1
            logger.warning("%s died (exit %s)%s", child.service,
                           child.proc.returncode,
                           stderr_tail(child.stderr_path))
            self._cleanup_stale(child.service)
        while len(self.children) < self.min_daemons and not self._stop:
            try:
                self.spawn()
            except OSError as e:
                # a failed respawn must not escape the beat: run()'s
                # finally would retire the HEALTHY daemons too,
                # turning one wedged child into a fleet outage. Leave
                # the floor short; the next beat retries.
                logger.warning("respawn failed: %s (retry next beat)",
                               e)
                break

    def _cleanup_stale(self, service: str) -> None:
        if self.pmux_port is None:
            return
        from ..control.pmux import PmuxClient

        try:
            with PmuxClient(port=self.pmux_port) as c:
                if c.delete(service):
                    self.stale_cleanups += 1
                bump_ring_epoch(c, service)
        except OSError as e:
            logger.warning("stale-entry cleanup failed: %s", e)

    def scrape(self) -> List[dict]:
        """Per-child status (skipping the unreachable — their reaping
        is :meth:`_reap_and_respawn`'s job)."""
        out = []
        for child in self.children.values():
            try:
                with _client(child.port) as c:
                    st = c.status()["status"]
            except (OSError, ValueError, KeyError):
                continue
            child.stats = st
            out.append(st)
        return out

    def beat(self, now: Optional[float] = None) -> dict:
        """One supervision round: reap/respawn, scrape, update EWMAs,
        apply the policy (cooldown-limited). Returns a summary for
        logs/tests."""
        now = _monotonic() if now is None else now
        self._reap_and_respawn()
        stats = self.scrape()
        depth = float(sum(s.get("queue_depth", 0) for s in stats))
        sessions = sum(s.get("stream", {}).get("sessions", 0)
                       for s in stats)
        rate = 0.0
        dt = (now - self._t_last_beat) if self._t_last_beat else None
        if dt and dt > 0:
            done = 0
            for child in self.children.values():
                cur = child.stats.get("completed", 0)
                done += max(cur - child.last_completed, 0)
                child.last_completed = cur
            rate = done / dt
        else:
            for child in self.children.values():
                child.last_completed = child.stats.get("completed", 0)
        self._t_last_beat = now
        a = self.ewma_alpha
        self.depth_ewma = (1 - a) * self.depth_ewma + a * depth
        if dt:
            self.drain_rate_ewma = ((1 - a) * self.drain_rate_ewma
                                    + a * rate)
        want = desired_count(
            len(self.children), self.depth_ewma,
            self.drain_rate_ewma, sessions,
            min_daemons=self.min_daemons,
            max_daemons=self.max_daemons,
            up_backlog_s=self.up_backlog_s,
            down_backlog_s=self.down_backlog_s,
            max_sessions=self.max_sessions)
        acted = None
        if want != len(self.children) \
                and now - self._t_scaled >= self.scale_cooldown_s:
            self._t_scaled = now
            if want > len(self.children):
                try:
                    self.spawn()
                    acted = "spawn"
                except OSError as e:
                    # cooldown already stamped — no hot retry loop
                    logger.warning("scale-up spawn failed: %s", e)
            else:
                # retire the newest shard with the fewest resident
                # sessions — the cheapest handoff
                shard = min(
                    self.children,
                    key=lambda i: (self.children[i].stats
                                   .get("stream", {})
                                   .get("sessions", 0), -i))
                self.retire(shard)
                acted = "retire"
        return {"daemons": len(self.children),
                "depth_ewma": round(self.depth_ewma, 3),
                "drain_rate_ewma": round(self.drain_rate_ewma, 3),
                "sessions": sessions, "action": acted,
                "deaths": self.deaths, "spawned": self.spawned,
                "retired": self.retired}

    def run(self, initial: Optional[int] = None) -> int:
        """The CLI loop: boot ``initial`` daemons (default
        ``min_daemons``), beat until signalled, drain the fleet on
        the way out."""
        for _ in range(initial if initial is not None
                       else self.min_daemons):
            self.spawn()
        print(json.dumps({
            "ready": True, "supervisor": True,
            "pmux_port": self.pmux_port,
            "daemons": {c.shard: c.port
                        for c in self.children.values()}}),
            flush=True)
        try:
            while not self._stop:
                summary = self.beat()
                if summary["action"]:
                    logger.info("beat: %s", summary)
                time.sleep(self.poll_s)
        finally:
            self.shutdown()
        return 0

    def stop(self, *_args) -> None:
        self._stop = True


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m comdb2_tpu_torch.service.supervisor",
        description="elastic verifier-fleet supervisor "
                    "(docs/service.md \"Elastic fleet\"); arguments "
                    "after -- pass through to every daemon")
    p.add_argument("--pmux", type=int, nargs="?", const=5105,
                   default=None, metavar="PORT",
                   help="ct_pmux port the fleet registers under "
                        "(default 5105 when given bare); without it "
                        "daemons run unregistered (no routing)")
    p.add_argument("--n", type=int, default=None,
                   help="initial fleet size (default: --min)")
    p.add_argument("--min", type=int, default=1, dest="min_daemons")
    p.add_argument("--max", type=int, default=4, dest="max_daemons")
    p.add_argument("--poll-s", type=float, default=1.0)
    p.add_argument("--drain-s", type=float, default=10.0)
    p.add_argument("--up-backlog-s", type=float, default=2.0,
                   help="scale up when queue-drain time exceeds this")
    p.add_argument("--down-backlog-s", type=float, default=0.2)
    p.add_argument("--max-sessions", type=int, default=64,
                   help="per-daemon session cap (the session-pressure "
                        "term of the policy; pass the same value to "
                        "the daemons after --)")
    p.add_argument("--stderr-dir", default=None, metavar="DIR",
                   help="write each daemon's stderr to "
                        "DIR/daemon-<shard>.err and report its tail "
                        "when the daemon dies (default: discarded)")
    argv = list(sys.argv[1:] if argv is None else argv)
    daemon_args: List[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, daemon_args = argv[:i], argv[i + 1:]
    args = p.parse_args(argv)
    sup = Supervisor(pmux_port=args.pmux,
                     min_daemons=args.min_daemons,
                     max_daemons=args.max_daemons,
                     daemon_args=daemon_args,
                     poll_s=args.poll_s,
                     drain_grace_s=args.drain_s,
                     up_backlog_s=args.up_backlog_s,
                     down_backlog_s=args.down_backlog_s,
                     max_sessions=args.max_sessions,
                     stderr_dir=args.stderr_dir)
    signal.signal(signal.SIGTERM, sup.stop)
    signal.signal(signal.SIGINT, sup.stop)
    return sup.run(initial=args.n)


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["Child", "Supervisor", "desired_count", "main", "stderr_tail"]
