#!/usr/bin/env python3
"""The stages of ``scripts/check_torch.sh`` (the port's repo gate) that
run Python: each the counterpart of a stage of the JAX package's
``scripts/check.sh``, over ``comdb2_tpu_torch`` on ``--device``.

Usage: python3 scripts/torch_gate.py STAGE [--device cuda|cpu]

Stages: txn-smoke, shrink-smoke, wl, mxu-smoke, multichip,
service-smoke, stream, routing, elastic, obs. Exit 0 when the stage
holds; any failed check raises (exit 1) with what it saw. Every daemon
runs with ``--backend`` = the device and its stderr in a file whose
tail is printed when it fails to start or exits non-zero. With
``--device cuda`` (the default) and no card, a stage that touches the
device exits non-zero before any work; none falls back to the CPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
import subprocess
import sys
import tempfile
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_fleet as FL  # noqa: E402
from comdb2_tpu_torch.service.supervisor import stderr_tail  # noqa: E402

FIX = os.path.join(REPO, "tests", "fixtures")
#: how long a daemon may take to its ready line (on the card it builds or
#: loads both kernel libraries first)
READY_S = 300.0


class GateError(Exception):
    pass


def _expect(ok: bool, msg: str) -> None:
    if not ok:
        raise GateError(msg)


def _device(name: str):
    """The stage's torch device; ``cuda`` without a card raises (no
    fallback)."""
    from comdb2_tpu_torch.utils import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise GateError(f"--device {name}: {e}") from None


def _filetests(*runs) -> list:
    """``python -m comdb2_tpu_torch.filetest ARGS`` for each ARGS in
    ``runs``, all started together (each pays its own torch import and
    CUDA context); their exit codes, in order."""
    procs = [subprocess.Popen([sys.executable, "-m",
                               "comdb2_tpu_torch.filetest", *args],
                              cwd=REPO, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for args in runs]
    rcs = []
    for p in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode not in (0, 1):
            print(err[-3000:], file=sys.stderr)
        rcs.append(p.returncode)
    return rcs


class Daemon:
    """One daemon for a stage: started with ``--backend`` = the device,
    stopped with ``shutdown``, reaped, and checked for leftovers."""

    def __init__(self, device: str, *args, log_dir: str, name: str):
        self.err = os.path.join(log_dir, f"{name}.err")
        self.proc, ready = FL.start_daemon(
            ["--backend", device, "--no-prime", *args], self.err,
            ready_s=READY_S)
        if ready is None:
            FL.stop_daemon(self.proc)
            raise GateError(f"{name} daemon printed no ready line (exit "
                            f"{self.proc.returncode})"
                            f"{stderr_tail(self.err)}")
        self.ready = ready
        self.port = ready["port"]

    def client(self):
        from comdb2_tpu_torch.service.client import ServiceClient

        return ServiceClient("127.0.0.1", self.port, timeout_s=300.0,
                             retries=5, backoff_s=0.5)

    def wait(self) -> None:
        """Wait for the exit a ``shutdown`` asked for; non-zero fails."""
        rc = FL.stop_daemon(self.proc)
        _expect(rc == 0, f"daemon exited {rc}{stderr_tail(self.err)}")
        left = FL.leftovers([self.proc.pid])
        _expect(not left["zombies"] and not left["alive"]
                and not left["compute_apps"],
                f"the daemon left {left} behind")

    def abort(self) -> None:
        """Shut it down and reap it after a failed check."""
        FL.stop_daemon(self.proc, self.port)


def _with_daemon(device, body, *args, name):
    with tempfile.TemporaryDirectory(prefix="torch_gate_") as log_dir:
        d = Daemon(device, *args, log_dir=log_dir, name=name)
        try:
            body(d)
        except BaseException:
            d.abort()
            print(f"{name} daemon{stderr_tail(d.err)}", file=sys.stderr)
            raise
        d.wait()


# --- txn-smoke / shrink-smoke -------------------------------------------------

def txn_smoke(device: str) -> None:
    """The seeded G2-item fixture is caught (exit 1) and its clean twin
    passes (exit 0), on the host engine."""
    bad, clean = _filetests(
        ("--txn", "--backend", "host", "--device", device,
         os.path.join(FIX, "txn", "g2_item.edn")),
        ("--txn", "--backend", "host", "--device", device,
         os.path.join(FIX, "txn", "clean.edn")))
    _expect(bad == 1, f"txn checker missed the seeded G2-item cycle "
                      f"(rc={bad})")
    _expect(clean == 0, f"txn checker flagged the clean fixture "
                        f"(rc={clean})")


def shrink_smoke(device: str) -> None:
    """``filetest --shrink`` reaches the known minimum of the stale-read
    fixture (2 ops) on the device, and the minimal history re-checks
    INVALID on the host."""
    _device(device)
    with tempfile.TemporaryDirectory(prefix="torch_gate_shrink_") as st:
        rc, = _filetests(("--shrink", "--store", st, "--device", device,
                          os.path.join(FIX, "shrink", "stale_read.edn")))
        _expect(rc == 1, f"shrink seed fixture not INVALID (rc={rc})")
        minimal = sorted(glob.glob(os.path.join(st, "shrink", "*",
                                                "minimal.edn")))
        _expect(bool(minimal), "shrink wrote no minimal.edn")
        with open(minimal[0]) as fh:
            n_ops = fh.read().count(":process")
        _expect(n_ops <= 2, f"shrink left {n_ops} ops (known minimum 2)")
        rc, = _filetests(("--backend", "host", "--device", device,
                          minimal[0]))
        _expect(rc == 1, f"minimal.edn re-check rc={rc} (must stay "
                         "INVALID)")


# --- wl -------------------------------------------------------------------------

def _wl_parity(device: str) -> None:
    """``scripts/bench_wl.py --quick``'s gate without its timing: per
    family and B in (8, 64), valid and violation twins, the device's
    verdict equals the host oracle's lane by lane, and each call is one
    device program per pow2 bucket; then one call over 16 histories
    against the 16 single-history calls it amortizes."""
    from comdb2_tpu_torch.checker import wl as W
    from comdb2_tpu_torch.checker.wl import batch as WLB

    dev = _device(device)
    gens = {"bank": lambda s, b, v: W.bank_batch(s, b, violation=v),
            "sets": lambda s, b, v: (W.sets_batch(s, b, violation=v),
                                     None),
            "dirty": lambda s, b, v: (W.dirty_batch(s, b, violation=v),
                                      None)}
    viols = {"bank": "total", "sets": "lost", "dirty": "dirty"}
    for family, gen in gens.items():
        for B in (8, 64):
            for viol in (None, viols[family]):
                hists, model = gen(1000 + B, B, viol)
                d0 = WLB.DISPATCHES
                got = W.check_wl_batch(hists, family, model, device=dev)
                _expect(WLB.DISPATCHES - d0 == 1,
                        f"{family} B={B}: {WLB.DISPATCHES - d0} device "
                        "programs for one bucket")
                host = WLB._host_fallback(hists, family, model)
                for i, (d, h) in enumerate(zip(got, host)):
                    _expect(d["valid?"] == h["valid?"],
                            f"{family} B={B} {viol} lane {i}: device {d} "
                            f"oracle {h}")
                _expect(all(d["valid?"] is (viol is None) for d in got),
                        f"{family} B={B} {viol}: a lane missed")
    hists, model = W.bank_batch(7, 16)
    d0 = WLB.DISPATCHES
    out = W.check_wl_batch(hists, "bank", model, device=dev)
    _expect(WLB.DISPATCHES - d0 == 1 and all(v["valid?"] is True
                                             for v in out),
            "16 bank histories are not one device program")
    d0 = WLB.DISPATCHES
    for h in hists:
        W.check_wl_batch([h], "bank", model, device=dev)
    _expect(WLB.DISPATCHES - d0 == 16, "a loop of 16 calls is not 16 "
                                       "programs")


def wl(device: str) -> None:
    """The workload-family fixtures through ``filetest`` (each seeded
    violation exit 1, each clean twin exit 0), the device-against-oracle
    parity, and a ``kind:"wl"`` round trip through a daemon."""
    _device(device)
    wl_fix = os.path.join(FIX, "wl")
    bank = ("--checker", "bank", "--wl-n", "8", "--wl-total", "160")
    runs = (("bank_valid", bank), ("bank_wrong_total", bank),
            ("sets_valid", ("--checker", "sets")),
            ("sets_lost", ("--checker", "sets")),
            ("dirty_valid", ("--checker", "dirty")),
            ("dirty_dirty", ("--checker", "dirty")))
    rcs = dict(zip((name for name, _ in runs), _filetests(*(
        (*args, "--device", device, os.path.join(wl_fix, f"{name}.edn"))
        for name, args in runs))))
    want = {k: 0 if k.endswith("_valid") else 1 for k in rcs}
    _expect(rcs == want, f"wl fixtures: exit codes {rcs}, want {want}")
    _wl_parity(device)

    def body(d):
        from comdb2_tpu_torch.checker import wl as W
        from comdb2_tpu_torch.ops.history import history_to_edn

        good, model = W.bank_batch(61, 1)
        bad, _ = W.bank_batch(61, 1, violation="total")
        with d.client() as c:
            r = c.check_wl(history_to_edn(list(good[0])), "bank", wl=model)
            _expect(r["ok"] and r["valid"] is True and r["kind"] == "wl"
                    and r["family"] == "bank", f"wl valid reply {r}")
            r = c.check_wl(history_to_edn(list(bad[0])), "bank", wl=model)
            _expect(r["ok"] and r["valid"] is False and r["bad-reads"]
                    and r["engine"] == "wl-device", f"wl twin reply {r}")
            _expect(c.shutdown(), "shutdown refused")

    _with_daemon(device, body, "--frontier", "64", name="wl")


# --- mxu-smoke / multichip ----------------------------------------------------

def mxu_smoke(device: str) -> None:
    """A genuinely concurrent P = 16 history VALID and its seeded
    violation INVALID, both from the MXU frontier engine."""
    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import synth_columnar as SC

    dev = _device(device)
    for violation, want in ((False, True), (True, False)):
        h = SC.wide_register_batch_packed(
            101, 1, n_waves=2, n_chain=13, n_free=3, values=16,
            violation=violation)[0]
        a = analysis(cas_register(), h, backend="device", host_threshold=1,
                     device=dev)
        _expect(a.valid is want, f"mxu smoke violation={violation}: "
                                 f"{a.valid} {a.info}")
        _expect(a.info.get("engine") == "mxu-frontier",
                f"mxu smoke engine {a.info.get('engine')}")
    print("mxu smoke: wide-P valid VALID, seeded violation INVALID, "
          "engine=mxu-frontier", file=sys.stderr)


def _overflow_history(k: int):
    """k concurrent writes of k values: 1 + sum_s C(k, s) s configs at
    the first ok (k = 6: 193, k = 7: 449), past the kernel's 128."""
    from comdb2_tpu_torch.ops import op as O

    return ([O.invoke(p, "write", p) for p in range(k)]
            + [O.ok(p, "write", p) for p in range(k)])


def multichip(device: str) -> None:
    """The port's mesh route (``service.sharding.make_mesh``): D = 8 on
    the CPU, D = 1 on the card (one card on the host). The stream kernel
    over the mesh (``stream-sharded``) against the keys engine, a kernel
    overflow escalated on one shard, the in-place seg2 ladder, a wide-P
    history, and 256 histories across the mesh with INVALID lanes."""
    import numpy as np

    from comdb2_tpu_torch.checker import analysis, linear_host
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker.batch import check_batch, pack_batch
    from comdb2_tpu_torch.models.memo import memo as make_memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import (mutate, pinned_wide_history,
                                             register_history)
    from comdb2_tpu_torch.service.sharding import make_mesh

    dev = _device(device)
    D = 8 if dev.type == "cpu" else 1
    mesh = make_mesh(D, device=device)
    # a one-device mesh is the plain stream route, as in the JAX package
    route = "stream-sharded" if D > 1 else "stream"
    rng = random.Random(7)
    batch = pack_batch([register_history(rng, n_procs=4, n_events=48,
                                         p_info=0.0)
                        for _ in range(2 * D)], cas_register())
    info: dict = {}
    st, fa, nf = check_batch(batch, F=64, mesh=mesh, info=info)
    _expect((st == 0).all(), f"sharded check misjudged: {st}")
    _expect(info.get("engine") == route,
            f"the kernel did not serve the mesh: {info.get('engine')}")
    info2: dict = {}
    st2, fa2, nf2 = check_batch(batch, F=64, mesh=mesh, engine="keys",
                                info=info2)
    _expect((st == st2).all() and (fa == fa2).all() and (nf == nf2).all(),
            f"kernel/keys divergence: {st} {st2}")
    rng = random.Random(13)
    hs = [register_history(rng, n_procs=4, n_events=48, p_info=0.0)
          for _ in range(7)] + [_overflow_history(6)]
    info = {}
    st, _, _ = check_batch(pack_batch(hs, cas_register()), F=256,
                           mesh=mesh, info=info)
    esc = info.get("escalated")
    _expect((st == 0).all() and esc and esc.get("count") == 1
            and esc.get("engine"), f"escalation stage: {st} {info}")
    a = analysis(cas_register(), _overflow_history(7), backend="device",
                 capacities=(256, 1024), device=dev)
    _expect(a.valid is True and a.info.get("frontier_capacity") == 1024,
            f"ladder stage: {a.valid} {a.info}")
    h = pinned_wide_history(18)
    packed = pack_history(h)
    mm = make_memo(cas_register(), packed)
    hr = linear_host.check(mm, packed, max_configs=1 << 16)
    a = analysis(cas_register(), packed, backend="device", device=dev)
    p_eff = a.info.get("effective_slots", 0)
    plan = LT.make_pack_plan(mm.n_states, mm.n_transitions,
                             p_eff + (p_eff & 1))
    _expect(a.valid is hr.valid is True and p_eff >= 18
            and plan is not None and plan.n_words >= 2,
            f"wide-P stage: {a.valid} {hr.valid} {p_eff} {plan}")
    rng = random.Random(23)
    hs = []
    for i in range(256):
        h = register_history(rng, n_procs=4, n_events=32, p_info=0.0)
        hs.append(mutate(rng, h) if i % 8 == 3 else h)
    batch = pack_batch(hs, cas_register())
    info = {}
    st, fa, nf = check_batch(batch, F=128, mesh=mesh, info=info)
    _expect(info.get("engine") == route,
            f"256-history stage engine {info.get('engine')}")
    st2, fa2, nf2 = check_batch(batch, F=128, mesh=mesh, engine="keys")
    valid = st == 0
    _expect((st == st2).all() and (fa == fa2).all()
            and np.array_equal(nf[valid], nf2[valid]),
            "256-history kernel/keys divergence")
    _expect(int((st == 1).sum()) >= 8,
            f"only {int((st == 1).sum())} INVALID lanes")
    print(f"multichip: {route} over D = {D} {dev.type} slot(s), "
          "kernel == keys, escalation, ladder to 1024, wide-P, 256 "
          "histories", file=sys.stderr)


# --- the daemon stages -------------------------------------------------------

def service_smoke(device: str) -> None:
    """One daemon: a check, the status counters, a clean shutdown, no
    leftover process or zombie."""
    _device(device)

    def body(d):
        from comdb2_tpu_torch.ops import op as O

        h = [O.invoke(0, "write", 1), O.ok(0, "write", 1),
             O.invoke(1, "read", None), O.Op(1, "ok", "read", 1)]
        with d.client() as c:
            r = c.check(h)
            _expect(r.get("ok") and r.get("valid") is True, f"check {r}")
            st = c.status()["status"]
            _expect(st["completed"] >= 1 and st["dispatches"] >= 1,
                    f"status {st}")
            _expect(c.shutdown(), "shutdown refused")

    _with_daemon(device, body, "--frontier", "64", name="service")


def stream(device: str) -> None:
    """Stream sessions through a daemon: a clean delta, a violating
    delta that latches, an append after the latch answered without
    device work, close; two sessions appending together share one
    megabatched beat; the session gauges in the metrics."""
    _device(device)

    def body(d):
        from comdb2_tpu_torch.ops import op as O
        from comdb2_tpu_torch.ops.history import history_to_edn

        clean = [O.invoke(0, "write", 1), O.ok(0, "write", 1),
                 O.invoke(1, "read", None), O.Op(1, "ok", "read", 1)]
        bad = [O.invoke(1, "read", None), O.Op(1, "ok", "read", 9)]
        with d.client() as c, d.client() as ca, d.client() as cb:
            r = c.stream_open()
            _expect(r.get("ok") and r.get("session"), f"open {r}")
            sid = r["session"]
            r = c.stream_append(sid, history_to_edn(clean))
            _expect(r.get("ok") and r.get("valid") is True
                    and r.get("checked_through") == 4, f"append {r}")
            r = c.stream_append(sid, history_to_edn(bad))
            _expect(r.get("ok") and r.get("valid") is False, f"bad {r}")
            r = c.stream_append(sid, history_to_edn(clean))
            _expect(r.get("ok") and r.get("valid") is False
                    and r.get("latched"), f"latched {r}")
            r = c.stream_close(sid)
            _expect(r.get("ok") and r.get("valid") is False, f"close {r}")
            sa = ca.stream_open()["session"]
            sb = cb.stream_open()["session"]
            fused = False
            for attempt in range(3):
                mb0 = c.status()["status"]["stream_megabatches"]
                delta = [O.invoke(0, "write", attempt),
                         O.ok(0, "write", attempt),
                         O.invoke(1, "read", None),
                         O.Op(1, "ok", "read", attempt)]
                bar = threading.Barrier(2)
                res = {}

                def go(cli, sid, key):
                    bar.wait()
                    res[key] = cli.stream_append(sid,
                                                 history_to_edn(delta))

                ts = [threading.Thread(target=go, args=(ca, sa, "a")),
                      threading.Thread(target=go, args=(cb, sb, "b"))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                _expect(res["a"].get("valid") is True
                        and res["b"].get("valid") is True, f"beat {res}")
                if c.status()["status"]["stream_megabatches"] > mb0:
                    fused = True
                    break
            _expect(fused, "concurrent same-class appends never shared a "
                           "dispatch")
            ca.stream_close(sa)
            cb.stream_close(sb)
            st = c.status()["status"]
            _expect(st["stream_opens"] >= 3 and st["stream_appends"] >= 5
                    and st["stream"]["sessions"] == 0, f"status {st}")
            m = c.metrics()
            _expect("stream_sessions_active" in m["prometheus"]
                    and "sessions_per_dispatch" in m["prometheus"],
                    "session gauges missing from the metrics")
            _expect(c.shutdown(), "shutdown refused")

    _with_daemon(device, body, "--frontier", "256", "--max-sessions", "4",
                 "--fill-ms", "50", name="stream")


def routing(device: str) -> None:
    """Two daemons registered under ``ct_pmux`` as ``sut/verifier/0`` and
    ``/1``; the consistent-hash client routes 8 requests of 4 size
    classes, both daemons serve, everything shuts down clean."""
    _device(device)
    from comdb2_tpu_torch.ops.history import history_to_edn
    from comdb2_tpu_torch.ops.synth import register_history
    from comdb2_tpu_torch.service.client import RoutedClient

    pmux_port = FL.free_port()
    pmux = FL.start_pmux(FL.find_ct_pmux(), pmux_port)
    daemons = []
    try:
        with tempfile.TemporaryDirectory(prefix="torch_gate_rt_") as logs:
            try:
                for shard in (0, 1):
                    daemons.append(Daemon(
                        device, "--frontier", "64", "--pmux",
                        str(pmux_port), "--pmux-shard", str(shard),
                        log_dir=logs, name=f"routing-{shard}"))
                rc = RoutedClient.discover(pmux_port=pmux_port,
                                           timeout_s=300.0, retries=5,
                                           backoff_s=0.5)
                with rc:
                    _expect(set(rc.clients) == {"sut/verifier/0",
                                                "sut/verifier/1"},
                            f"discovered {sorted(rc.clients)}")
                    for i, n in enumerate((10, 18, 30, 60) * 2):
                        h = register_history(random.Random(100 + i), 3, n,
                                             p_info=0.0)
                        r = rc.check(history_to_edn(h))
                        _expect(r.get("ok") and r.get("valid") is True,
                                f"routed check {r}")
                    _expect(all(v > 0 for v in rc.served.values()),
                            f"a daemon served nothing: {rc.served}")
                    sts = rc.statuses()
                    _expect(len(sts) == 2 and all(
                        s["completed"] >= 1 for s in sts.values()),
                        f"statuses {sts}")
                    for c in rc.clients.values():
                        _expect(c.shutdown(), "shutdown refused")
                for d in daemons:
                    d.wait()
            except BaseException:
                for d in daemons:
                    d.abort()
                    print(f"{d.err}{stderr_tail(d.err)}",
                          file=sys.stderr)
                raise
    finally:
        FL.stop_pmux(pmux, pmux_port)


def elastic(device: str) -> None:
    """``scripts/torch_elastic.py --quick --backend DEVICE``: the
    SIGKILL nemesis, a join and a migration under the supervisor, the
    fleet history VALID; then none of its daemons alive, a zombie or a
    CUDA compute app (its own accounting, by pid, so another fleet on
    the host does not count)."""
    _device(device)
    with tempfile.TemporaryDirectory(prefix="torch_gate_el_") as tmp:
        out_path = os.path.join(tmp, "elastic.json")
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "torch_elastic.py"),
             "--quick", "--backend", device, "--out", out_path,
             "--log-dir", os.path.join(tmp, "logs")], cwd=REPO,
            timeout=1800)
        _expect(r.returncode == 0, f"torch_elastic.py exited "
                                   f"{r.returncode}")
        with open(out_path) as fh:
            out = json.load(fh)
    left = out["leftovers"]
    _expect(out["gate_ok"] and not left["zombies"] and not left["alive"]
            and not left["compute_apps"],
            f"the elastic gate left {left} behind")


def obs(device: str) -> None:
    """A daemon with ``--trace --store``: an INVALID check with its
    stages, a shrink, the metrics histograms filled; on shutdown a
    Perfetto ``trace.json`` with the admission / device / request spans
    and a ``timeline.svg``."""
    _device(device)
    with tempfile.TemporaryDirectory(prefix="torch_gate_obs_") as store:
        def body(d):
            from comdb2_tpu_torch.ops import op as O

            bad = [O.invoke(0, "write", 1), O.ok(0, "write", 1),
                   O.invoke(1, "read", None), O.Op(1, "ok", "read", 2)]
            with d.client() as c:
                r = c.check(bad)
                _expect(r["ok"] and r["valid"] is False and r.get("stages"),
                        f"check {r}")
                r = c.shrink(bad)
                _expect(r["ok"] and r["valid"] is False, f"shrink {r}")
                m = c.metrics()
                _expect(m["ok"] and m["kind"] == "metrics", f"metrics {m}")
                snap = m["metrics"]
                qw = sum(s["count"]
                         for s in snap["service_queue_wait_ms"]["series"])
                dv = sum(s["count"]
                         for s in snap["service_device_ms"]["series"])
                _expect(qw > 0 and dv > 0, f"histograms {qw} {dv}")
                _expect(snap["service_dispatches_total"]["series"][0]
                        ["value"] > 0, "no dispatch counted")
                _expect("service_queue_wait_ms_bucket" in m["prometheus"],
                        "no histogram buckets in the exposition")
                _expect(c.shutdown(), "shutdown refused")

        _with_daemon(device, body, "--frontier", "64", "--trace",
                     "--store", store, name="obs")
        trace = os.path.join(store, "service", "trace.json")
        _expect(os.path.getsize(trace) > 0 if os.path.exists(trace)
                else False, "the daemon wrote no trace.json")
        with open(trace) as fh:
            names = {e["name"] for e in json.load(fh)["traceEvents"]}
        _expect({"admission", "device", "request"} <= names,
                f"trace spans {sorted(names)}")
        svg = os.path.join(store, "service", "timeline.svg")
        _expect(os.path.exists(svg) and os.path.getsize(svg) > 0,
                "the daemon wrote no timeline.svg")


STAGES = {"txn-smoke": txn_smoke, "shrink-smoke": shrink_smoke, "wl": wl,
          "mxu-smoke": mxu_smoke, "multichip": multichip,
          "service-smoke": service_smoke, "stream": stream,
          "routing": routing, "elastic": elastic, "obs": obs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("stage", choices=sorted(STAGES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(min(torch.get_num_threads(), 4))
    try:
        STAGES[args.stage](args.device)
    except GateError as e:
        print(f"{args.stage}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
