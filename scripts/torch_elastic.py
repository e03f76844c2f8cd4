#!/usr/bin/env python3
"""Elastic-fleet gate of the port: the checker pointed at its own
serving layer, with the daemons on the card (docs/service.md "Elastic
fleet", docs/service_torch.md).

The counterpart of the JAX package's ``scripts/bench_elastic.py``, as a
gate: the same three scenarios and the same counts, no timing gate.

1. **kill a daemon under a burst**: SIGKILL one of two
   ``sut/verifier/<n>`` daemons mid-burst (no drain, no deregistration).
   The routed client fails over; the supervisor reaps the corpse,
   deletes its stale registration, bumps the ring epoch and respawns to
   the floor; the survivor serves the victim's classes.
2. **a daemon joins under a burst**: the epoch bump refreshes the
   client's ring and about 1/N of the keys remap, all onto the newcomer.
3. **session migration**: a streaming session's daemon drains; the
   client moves the session by checkpoint and the appends after the
   handoff stay O(delta) with 0 replays.

Every request the client sends is recorded as an op pair (process =
request id, ``invoke write [i 1]`` then ``ok``) and the fleet history is
checked, keyed, by the surviving fleet. Gated: every request answered
exactly once, the fleet history VALID, the remap share in (0,
``--max-remap``], every moved key on the newcomer, the newcomer served,
the migration (one move, 0 replays, O(delta) dispatches, the final
verdict VALID), the floor refilled, and no zombie, surviving daemon or
CUDA compute app of a daemon left. Wall times are printed, not gated.

On the card (``--backend cuda``, the default) each daemon builds or
loads both kernel libraries and primes them before its ready line, and
each daemon's kernel launches and card seconds are read from its
``metrics`` verb (right after its ready line, and before it is killed,
drained or retired); the gate then also needs the stream kernel, the
carry-mode segment search and the pair sort to have launched in the
fleet (the traffic holds an 8-process, 8-pending history that
overflows the kernel's 128 configs into the keys engine). There is no
fallback: without a card ``--backend cuda`` exits 2 before any work.
Each daemon's stderr goes to ``--log-dir`` (a temporary directory by
default) and is printed when a daemon dies unasked or never starts.

Usage: python3 scripts/torch_elastic.py [--backend cuda|cpu] [--quick]
           [--requests-per-class N] [--out FILE] [--log-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_fleet as FL  # noqa: E402
from comdb2_tpu_torch.service.supervisor import stderr_tail  # noqa: E402

#: event counts per size class: each its own pow2 payload class, split
#: over two daemons by the md5 ring (the JAX package's gate's classes)
SIZE_CLASSES = (10, 18, 30, 60, 140, 180)


def daemon_args(backend: str, frontier: int = 64) -> list:
    """Every daemon's flags: the backend, F and a 5 ms fill window; on
    the CPU without the priming dispatches (the card's daemon primes
    both kernels before its ready line)."""
    args = ["--backend", backend, "--frontier", str(frontier),
            "--fill-ms", "5"]
    return args + (["--no-prime"] if backend == "cpu" else [])


def req_history(i: int):
    """One request's op pair: its own key, one write — serving exactly
    once is exactly one completion per invocation."""
    from comdb2_tpu_torch.ops import op as O

    return (O.invoke(i, "write", (i, 1)), O.ok(i, "write", (i, 1)))


def class_histories(per_class: int, seed0: int, stride: int):
    """``per_class`` register histories in each of ``SIZE_CLASSES``."""
    from comdb2_tpu_torch.ops.synth import register_history

    return [register_history(random.Random(seed0 + stride * ci + j),
                             n_procs=3, n_events=n_events, p_info=0.0)
            for ci, n_events in enumerate(SIZE_CLASSES)
            for j in range(per_class)]


def overflow_history():
    """An 8-process, 8-pending history: it overflows the kernel's 128
    configs, and at F >= 1024 the keys engine (the pair sort) answers
    it."""
    from comdb2_tpu_torch.ops.synth import register_history

    return register_history(random.Random(0), n_procs=8, n_events=400,
                            values=5, p_info=0.0, max_pending=8)


def _launches(port: int) -> dict:
    """A daemon's kernel launches by kernel and its card seconds, from
    its ``metrics`` verb, and the requests it completed (``status``)."""
    from comdb2_tpu_torch.service.client import ServiceClient

    with ServiceClient("127.0.0.1", port, retries=0,
                       timeout_s=60.0) as c:
        m = c.metrics()["metrics"]
        completed = c.status()["status"]["completed"]
    out = {"completed": completed}
    out.update({s["labels"]["kernel"]: s["value"]
                for s in m["compile_kernel_launches_total"]["series"]})
    card = m.get("compile_kernel_card_seconds_total")
    out["card_s"] = (sum(s["value"] for s in card["series"])
                     if card else 0.0)
    return out


class _Scrapes:
    """Each daemon's counters since its ready line: the first scrape is
    its baseline, every later one its latest reading."""

    def __init__(self):
        self.base: dict = {}
        self.last: dict = {}

    def take(self, sup, only=None) -> None:
        for child in list(sup.children.values()):
            if only is not None and child.service != only:
                continue
            if child.proc.poll() is not None:
                continue
            try:
                got = _launches(child.port)
            except (OSError, ValueError, KeyError):
                continue
            self.base.setdefault(child.service, got)
            self.last[child.service] = got

    def per_daemon(self) -> dict:
        out = {}
        for svc, last in self.last.items():
            base = self.base[svc]
            out[svc] = {k: last.get(k, 0) - base.get(k, 0) for k in last}
        return out

    def fleet(self) -> dict:
        tot: dict = {}
        for d in self.per_daemon().values():
            for k, v in d.items():
                tot[k] = tot.get(k, 0) + v
        return tot


def run(backend: str = "cuda", requests_per_class: int = 6,
        max_remap: float = 0.7, log_dir: str = None, frontier: int = 64,
        burst=None, join_burst=None, stream_history=None,
        keep_replies: bool = False) -> dict:
    """The three scenarios and the self-check; returns the record with
    ``gate_ok``. ``burst`` / ``join_burst`` (lists of histories) replace
    the size-class traffic of phases 1 and 2, ``stream_history`` the
    migrated session's; ``keep_replies`` keeps every request's history
    and reply (``replies``: request id -> (history, reply))."""
    import torch

    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.ops.synth import register_history
    from comdb2_tpu_torch.service.client import RoutedClient, ServiceError
    from comdb2_tpu_torch.service.supervisor import Supervisor

    if backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda but CUDA is not available; "
                         "--backend cpu runs the plain versions")
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="torch_elastic_")
    out: dict = {"gate": "elastic", "backend": backend,
                 "size_classes": list(SIZE_CLASSES), "log_dir": log_dir,
                 "frontier": frontier}
    pmux_port = FL.free_port()
    pmux = FL.start_pmux(FL.find_ct_pmux(), pmux_port)
    sup = Supervisor(pmux_port=pmux_port, min_daemons=2, max_daemons=4,
                     daemon_args=daemon_args(backend, frontier),
                     drain_grace_s=5.0, scale_cooldown_s=1e9,
                     stderr_dir=log_dir)
    scrapes = _Scrapes()
    pids: set = set()
    fleet_ops: list = []
    answered: dict = {}
    failures: dict = {}
    replies: dict = {}
    walls: dict = {}
    rc = None
    gate_ok = False

    def note_children():
        for child in sup.children.values():
            pids.add(child.proc.pid)
        scrapes.take(sup)

    def beat():
        """One supervisor beat, each live daemon scraped just before it:
        a beat may retire a daemon (the policy's first scale-down is not
        held back by the cooldown), and its counts go with it."""
        scrapes.take(sup)
        sup.beat()
        note_children()

    def drive(i: int, h, route: str = "shape") -> None:
        inv, ok = req_history(i)
        fleet_ops.append(inv)
        text = history_to_edn(h)
        try:
            r = rc.check(text, route=route)
        except (OSError, ServiceError) as e:
            failures[i] = str(e)
            return
        if keep_replies:
            replies[i] = (h, r)
        if r.get("ok"):
            answered[i] = answered.get(i, 0) + 1
            fleet_ops.append(ok)
        else:
            failures[i] = r.get("error", "?")

    try:
        t0 = time.perf_counter()
        sup.spawn()
        sup.spawn()
        walls["boot_s"] = time.perf_counter() - t0
        note_children()
        rc = RoutedClient.discover(pmux_port=pmux_port, timeout_s=300.0,
                                   retries=1, backoff_s=0.05)
        assert len(rc.clients) == 2, rc.clients
        epoch0 = rc.epoch

        # --- phase 1: SIGKILL one daemon mid-burst ------------------------
        hs = (list(burst) if burst is not None
              else class_histories(requests_per_class, 9000, 37))
        n = len(hs)
        kill_at = n // 3
        victim = sup.children[0]
        served_before_kill = None
        t0 = time.perf_counter()
        t_kill = None
        for i, h in enumerate(hs):
            if i == kill_at:
                scrapes.take(sup, only=victim.service)
                # the nemesis: SIGKILL, no drain, no reap here — the
                # supervisor's beat polls and reaps the corpse
                victim.proc.kill()  # analysis: ignore[wait-after-kill]
                t_kill = time.perf_counter()
                served_before_kill = dict(rc.served)
            drive(i, h)
            if i % 4 == 3:
                beat()              # reap + stale cleanup + refill
        deadline = time.monotonic() + 300
        while len(sup.children) < 2 and time.monotonic() < deadline:
            beat()
            time.sleep(0.2)
        walls["burst_s"] = time.perf_counter() - t0
        walls["kill_to_floor_s"] = time.perf_counter() - t_kill
        survivor = next(name for name in served_before_kill
                        if name != victim.service)
        out["kill"] = {
            "victim": victim.service, "victim_pid": victim.proc.pid,
            "victim_exit": victim.proc.returncode,
            "killed_at_request": kill_at, "requests": n,
            "failovers": rc.failovers, "ring_refreshes": rc.refreshes,
            "stale_cleanups": sup.stale_cleanups,
            "deaths_reaped": sup.deaths,
            "respawned_to_floor": len(sup.children) >= 2,
            "survivor": survivor,
            "survivor_served_after_kill":
                rc.served[survivor] - served_before_kill[survivor]}
        assert out["kill"]["survivor_served_after_kill"] > 0, \
            "survivor served nothing after the kill"

        # --- phase 2: a daemon joins under a burst -------------------------
        rc.maybe_refresh(force=True)
        probes = [f"probe|{i}" for i in range(512)]
        owners_before = {k: rc.ring.nodes_for(k)[0] for k in probes}
        t0 = time.perf_counter()
        joined = sup.spawn()                # registers + bumps epoch
        walls["join_ready_s"] = time.perf_counter() - t0
        note_children()
        extra = (list(join_burst) if join_burst is not None
                 else class_histories(requests_per_class, 5000, 31))
        t0 = time.perf_counter()
        for k, h in enumerate(extra):
            drive(n + k, h)
        n_total = n + len(extra)
        assert rc.epoch != epoch0, (epoch0, rc.epoch)
        owners_after = {k: rc.ring.nodes_for(k)[0] for k in probes}
        moved = [k for k in probes if owners_before[k] != owners_after[k]]
        remap_frac = len(moved) / len(probes)
        join_clean = all(owners_after[k] == joined.service for k in moved)
        # payload routing spreads a dense key space: drive the newcomer
        # with recorded traffic that provably hashes to it
        probe_hs = [h for h in extra
                    if rc.ring.nodes_for(RoutedClient.route_key(
                        history_to_edn(h), route="payload"))[0]
                    == joined.service]
        for h in probe_hs[:4]:
            drive(n_total, h, route="payload")
            n_total += 1
        walls["join_burst_s"] = time.perf_counter() - t0
        newcomer_serves = rc.served.get(joined.service, 0)
        out["join"] = {
            "service": joined.service, "epoch_before": epoch0,
            "epoch_after": rc.epoch, "remapped_fraction": remap_frac,
            "moved_only_to_newcomer": join_clean,
            "max_remap_gate": max_remap,
            "newcomer_served": newcomer_serves}

        # --- phase 3: session migration off a draining daemon --------------
        sh = (list(stream_history) if stream_history is not None
              else register_history(random.Random(77), n_procs=3,
                                    n_events=96, p_info=0.0,
                                    max_pending=2))
        t0 = time.perf_counter()
        stream = rc.stream_open()
        cut = len(sh) // 2
        r1 = stream.append(sh[:cut])
        assert r1.get("ok") and r1["valid"] is True, r1
        d_half = r1["dispatches"]
        pinned = stream.node
        scrapes.take(sup, only=pinned)
        rc.clients[pinned].drain()
        time.sleep(0.3)                     # let its loop enter drain
        r2 = stream.append(sh[cut:])
        assert r2.get("ok") and r2["valid"] is True, r2
        closed = stream.close()
        walls["migration_s"] = time.perf_counter() - t0
        out["stream"] = {
            "pinned": pinned, "migrated_to": stream.node,
            "migrations": stream.migrations,
            "engine_before": r1.get("engine"),
            "engine_after": r2.get("engine"),
            "replays_after_handoff": r2.get("replays", -1),
            "dispatches_first_half": d_half,
            "dispatches_total": r2["dispatches"],
            "final_valid": closed.get("valid")}
        migration_ok = (stream.migrations == 1 and stream.node != pinned
                        and r2.get("replays") == 0
                        and r2["dispatches"] - d_half <= d_half + 2
                        and closed.get("valid") is True)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            beat()
            if all(c.proc.poll() is None for c in sup.children.values()) \
                    and len(sup.children) >= 2:
                break
            time.sleep(0.2)

        # --- the self-check -------------------------------------------------
        exactly_once = (len(answered) == n_total
                        and all(v == 1 for v in answered.values())
                        and not failures)
        t0 = time.perf_counter()
        verdict = rc.check(history_to_edn(fleet_ops), keyed=True,
                           raise_on_error=False)
        walls["self_check_s"] = time.perf_counter() - t0
        scrapes.take(sup)
        out["self_check"] = {
            "requests": n_total, "answered_exactly_once": exactly_once,
            "dropped": sorted(set(range(n_total)) - set(answered)),
            "failures": failures,
            "double_served": sorted(k for k, v in answered.items()
                                    if v > 1),
            "fleet_history_ops": len(fleet_ops),
            "fleet_history_valid": verdict.get("valid"),
            "checker_engine": verdict.get("engine")}
        out["supervisor"] = {"spawned": sup.spawned,
                             "retired": sup.retired, "deaths": sup.deaths,
                             "stale_cleanups": sup.stale_cleanups}
        gate_ok = (exactly_once and verdict.get("valid") is True
                   and 0 < remap_frac <= max_remap and join_clean
                   and newcomer_serves > 0 and migration_ok
                   and out["kill"]["respawned_to_floor"])
    finally:
        if rc is not None:
            rc.close()
        sup.shutdown()
        FL.stop_pmux(pmux, pmux_port)

    out["daemons"] = scrapes.per_daemon()
    out["fleet_launches"] = scrapes.fleet()
    out["walls_s"] = walls
    left = FL.leftovers(pids)
    out["leftovers"] = left
    clean = not left["zombies"] and not left["alive"] \
        and not left["compute_apps"]
    kernels_ok = True
    if backend == "cuda":
        fl = out["fleet_launches"]
        kernels_ok = (fl.get("seg_search_stream", 0) > 0
                      and fl.get("seg_search", 0) > 0
                      and fl.get("pair_sort", 0) > 0
                      and out["stream"]["engine_before"] == "kernel")
        out["kernels_launched_in_fleet"] = kernels_ok
    out["gate_ok"] = bool(gate_ok and clean and kernels_ok)
    if keep_replies:
        out["replies"] = replies
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="cuda", choices=["cuda", "cpu"],
                    help="where the daemons run: cuda (the card; no "
                         "fallback) or cpu (the plain versions)")
    ap.add_argument("--requests-per-class", type=int, default=6)
    ap.add_argument("--quick", action="store_true",
                    help="two requests per size class (the gate's "
                         "elastic stage)")
    ap.add_argument("--max-remap", type=float, default=0.7,
                    help="gate on the join's remapped key share "
                         "(about 1/3 expected at N = 2 -> 3)")
    ap.add_argument("--out", help="write the JSON record here")
    ap.add_argument("--log-dir", help="each daemon's stderr file goes "
                                      "here (default: a temporary "
                                      "directory)")
    args = ap.parse_args(argv)
    if args.quick:
        args.requests_per_class = min(args.requests_per_class, 2)
    burst = join_burst = None
    if args.backend == "cuda":
        # the keys escalation behind a routed daemon: one overflowing
        # lane in each burst, at a frontier it resolves at
        burst = class_histories(args.requests_per_class, 9000, 37)
        burst.insert(len(burst) // 2, overflow_history())
        join_burst = class_histories(args.requests_per_class, 5000, 31)
    try:
        out = run(args.backend, args.requests_per_class, args.max_remap,
                  args.log_dir, frontier=1024 if args.backend == "cuda"
                  else 64, burst=burst, join_burst=join_burst)
    except BaseException as e:
        log_dir = args.log_dir
        if log_dir and os.path.isdir(log_dir):
            for name in sorted(os.listdir(log_dir)):
                print(f"--- {name}{stderr_tail(os.path.join(log_dir, name))}",
                      file=sys.stderr)
        if isinstance(e, SystemExit):
            print(e, file=sys.stderr)
            return 2
        raise
    line = json.dumps(out, default=str)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    if not out["gate_ok"]:
        for name in sorted(os.listdir(out["log_dir"])):
            print(f"--- {name}"
                  f"{stderr_tail(os.path.join(out['log_dir'], name))}",
                  file=sys.stderr)
        print("FAIL: elastic gate", file=sys.stderr)
        return 1
    # the fleet wrote registrations and stores: the port's static
    # analysis must stay clean after the run (a fresh process, so its
    # verdict does not depend on this one's imports)
    r = subprocess.run([sys.executable, "-m", "comdb2_tpu_torch.analysis",
                        "--no-trace"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        print("FAIL: static analysis not clean after the run:\n"
              f"{r.stdout}{r.stderr}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
