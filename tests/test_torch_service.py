"""The port's ``VerifierCore`` against the JAX package's, on CPU.

Both cores get the same ``submit`` / ``pump`` / ``tick`` calls on one
injected clock; the port's runs with ``device="cpu"`` (its kernels as
their plain versions). Held equal, for every request: the reply's
``ok`` / ``error``, ``valid``, fail index (``op_index``), ``cause`` and
``bucket``, with the kind's own fields (txn anomalies, wl family
fields, shrink sizes and minimal history, stream verdicts; the final
frontier count where the verdict is VALID — on INVALID the kernel
zeroes it and the key engines keep the count before the frontier died,
the JAX package's cross-engine contract); and the
admission counters (``accepted``, ``completed``, ``overloads``,
``deadline_expired``, ``host_degraded``, ``dispatches``, the launch
reasons and the per-kind counts). The scenario covers the check, txn,
wl, shrink and stream kinds, a deadline expiry, host degradation,
trivial / malformed / bad requests, overload with ``retry_after_ms``,
a session's checkpoint and restore, and drain.

The ``engine`` field is not compared for the check kind: on CPU the
JAX package has no fused kernel and its ``auto`` takes keys, the port's
takes its stream kernel's plain version (at F = 256 both give every
verdict at the same capacity). Stream sessions open with ``rung:
"xla"`` in both, so their dispatch counts compare (the port's ``auto``
takes its kernel rung on CPU, one dispatch per delta).

Also: ``bucket_for`` / ``txn_bucket_for`` / ``wl_bucket_for`` over a
seeded sweep, the metrics exposition byte for byte for the same
registry calls, and the stage split tiling each reply's latency.
"""

import os
import random

import pytest
import torch

from comdb2_tpu.obs import metrics as JMET
from comdb2_tpu.ops.history import history_to_edn
from comdb2_tpu.ops.packed import pack_history as jax_pack
from comdb2_tpu.ops.synth import mutate, register_history
from comdb2_tpu.service import bucketing as JBK
from comdb2_tpu.service import VerifierCore as JCore

from comdb2_tpu_torch.obs import metrics as TMET
from comdb2_tpu_torch.obs import trace as tobs
from comdb2_tpu_torch.ops.native_loader import parse_history_fast
from comdb2_tpu_torch.ops.packed import pack_history as torch_pack
from comdb2_tpu_torch.service import bucketing as TBK
from comdb2_tpu_torch.service import VerifierCore as TCore

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

#: the counters held equal after the scenario
COUNTERS = ("accepted", "completed", "overloads", "bad_requests",
            "malformed", "deadline_expired", "host_degraded",
            "engine_errors", "dispatches", "launch_full",
            "launch_deadline", "launch_idle", "shrink_requests",
            "stream_opens", "stream_appends", "stream_closes",
            "stream_checkpoints", "stream_migrations", "drains",
            "wl_checks")

#: reply fields held equal when either reply has them
FIELDS = ("ok", "error", "valid", "op_index", "cause", "bucket", "kind",
          "batched", "retry_after_ms", "draining", "anomalies",
          "anomaly_class", "cycle", "txn_count", "family", "seed_ops",
          "minimal_ops", "rounds", "candidates", "one_minimal", "partial",
          "minimal_history", "released", "migrated", "latched",
          "final_count", "degraded")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(*parts):
    with open(os.path.join(FIX, *parts)) as fh:
        return fh.read()


class Twin:
    """One JAX core and one port core driven by the same calls."""

    def __init__(self, **kw):
        self.j = JCore(**kw)
        self.t = TCore(device="cpu", **kw)
        self.pairs = []          # (label, jax reply, port reply)

    def submit(self, req, now, label=None, treq=None):
        pj, rj = self.j.submit(dict(req), now)
        pt, rt = self.t.submit(dict(treq or req), now)
        assert (pj is None) == (pt is None), (req, rj, rt)
        if rj is not None:
            self.pairs.append((label or req.get("id"), rj, rt))
        return rj, rt

    def pump(self, now, idle=False):
        dj = self.j.pump(now, idle=idle)
        dt = self.t.pump(now, idle=idle)
        rj = sorted((r for _, r in dj), key=lambda r: str(r.get("id")))
        rt = sorted((r for _, r in dt), key=lambda r: str(r.get("id")))
        assert [r.get("id") for r in rj] == [r.get("id") for r in rt]
        for a, b in zip(rj, rt):
            self.pairs.append((a.get("id"), a, b))
        return list(zip(rj, rt))

    def tick(self, now):
        return self.pump(now, idle=True)


def _check(rid, h, **kw):
    return {"op": "check", "id": rid, "history": history_to_edn(list(h)),
            **kw}


def _group_by_bucket(n_events, n, seed):
    """Histories (some mutated) grouped by the bucket they land in."""
    rng = random.Random(seed)
    groups = {}
    for i in range(n):
        h = register_history(rng, 3, n_events, p_info=0.0)
        if i % 3 == 1:
            h = mutate(rng, h)
        b = JBK.bucket_for(jax_pack(list(h)), JBK.ServiceLimits())
        groups.setdefault(b.key, []).append(h)
    return max(groups.values(), key=len)


@pytest.fixture(scope="module")
def scenario():
    tw = Twin(F=256, batch_cap=4, max_queue=16,
              limits=JBK.ServiceLimits(max_ops=120))
    TBK_limits = TBK.ServiceLimits(max_ops=120)
    tw.t.limits = TBK_limits
    grp = _group_by_bucket(24, 40, seed=3)
    assert len(grp) >= 8, "fixture: too few histories share a bucket"
    t = 0.0
    # continuous batching: the 4th request fills the cap and launches
    for i in range(4):
        tw.submit(_check(f"full{i}", grp[i]), t)
    tw.pump(t + 0.001)
    tw.tick(t + 0.002)
    # a forming batch launches when its fill window passes
    t = 1.0
    for i in range(4, 6):
        tw.submit(_check(f"dl{i}", grp[i]), t)
    tw.pump(t + 0.001)                      # not due yet
    tw.pump(t + 0.010)                      # due: launch_deadline
    tw.tick(t + 0.011)
    # a deadline that passes in the queue answers unknown
    t = 2.0
    tw.submit(_check("expire", grp[6], deadline_ms=2), t)
    tw.pump(t + 0.050)
    # immediate answers: trivial, malformed, bad requests
    from comdb2_tpu.ops import op as O

    tw.submit(_check("trivial", [O.invoke(0, "write", 1)]), t)
    tw.submit(_check("malformed", [O.invoke(0, "write", 1),
                                   O.invoke(0, "write", 2),
                                   O.ok(0, "write", 2)]), t)
    tw.submit({"op": "check", "id": "nohist"}, t)
    tw.submit(_check("badmodel", grp[0], model="no-such-model"), t)
    tw.submit(_check("baddl", grp[0], deadline_ms="soon"), t)
    tw.submit({"op": "check", "id": "badkind", "kind": "nope",
               "history": "[]"}, t)
    # over the limits: the host engine, one request alone
    long_h = register_history(random.Random(9), 3, 150, p_info=0.0)
    tw.submit(_check("host", mutate(random.Random(1), long_h)), t)
    tw.pump(t + 0.001)
    # txn kind
    t = 3.0
    for name in ("clean", "g1c", "g2_item"):
        tw.submit({"op": "check", "id": f"txn-{name}", "kind": "txn",
                   "history": _read("txn", f"{name}.edn")}, t)
    tw.tick(t + 0.001)
    # wl kind, every family
    t = 4.0
    for fam, name, wl in (("bank", "bank_valid", {"n": 8, "total": 160}),
                          ("bank", "bank_wrong_total",
                           {"n": 8, "total": 160}),
                          ("sets", "sets_valid", None),
                          ("sets", "sets_lost", None),
                          ("dirty", "dirty_valid", None),
                          ("dirty", "dirty_dirty", None)):
        tw.submit({"op": "check", "id": f"wl-{name}", "kind": "wl",
                   "family": fam, "wl": wl,
                   "history": _read("wl", f"{name}.edn")}, t)
    tw.submit({"op": "check", "id": "wl-bad", "kind": "wl",
               "family": "bank", "history": "[]"}, t)
    tw.tick(t + 0.001)
    # shrink kind: one ddmin round per pump
    t = 5.0
    tw.submit({"op": "check", "id": "shrink", "kind": "shrink",
               "history": _read("shrink", "stale_read.edn")}, t)
    for i in range(200):
        if tw.tick(t + 0.001 * (i + 1)):
            break
    # stream kind: open, appends, poll, checkpoint hand-off, restore,
    # close
    t = 6.0
    h = register_history(random.Random(8), 3, 48, p_info=0.0)
    bad = mutate(random.Random(2), register_history(random.Random(2), 3,
                                                    48, p_info=0.0))
    rj, rt = tw.submit({"op": "check", "id": "open", "kind": "stream",
                        "verb": "open", "rung": "xla"}, t)
    sid = {"j": rj["session"], "t": rt["session"]}

    def sverb(rid, verb, now, **kw):
        req = {"op": "check", "id": rid, "kind": "stream", "verb": verb,
               **kw}
        return tw.submit({**req, "session": sid["j"]}, now,
                         treq={**req, "session": sid["t"]})

    for k, (a, b) in enumerate(((0, 16), (16, 32))):
        sverb(f"app{k}", "append", t + 0.01 * k,
              history=history_to_edn(h[a:b]))
        tw.tick(t + 0.01 * k + 0.001)
    sverb("poll", "poll", t + 0.1)
    ckj, ckt = sverb("ck", "checkpoint", t + 0.2, release=True)
    rj, rt = tw.submit({"op": "check", "id": "restore", "kind": "stream",
                        "verb": "open", "checkpoint": ckj["checkpoint"]},
                       t + 0.3,
                       treq={"op": "check", "id": "restore",
                             "kind": "stream", "verb": "open",
                             "checkpoint": ckt["checkpoint"]})
    sid = {"j": rj["session"], "t": rt["session"]}
    sverb("app2", "append", t + 0.4, history=history_to_edn(h[32:]))
    tw.tick(t + 0.41)
    sverb("close", "close", t + 0.5)
    rj, rt = tw.submit({"op": "check", "id": "open2", "kind": "stream",
                        "verb": "open", "rung": "xla"}, t + 0.6)
    sid = {"j": rj["session"], "t": rt["session"]}
    sverb("bad0", "append", t + 0.7, history=history_to_edn(bad))
    tw.tick(t + 0.71)
    sverb("latched", "append", t + 0.8, history=history_to_edn(bad[:2]))
    sverb("close2", "close", t + 0.9)
    sverb("gone", "poll", t + 1.0)
    # drain: queued work answers shutting-down, new work is shed
    t = 8.0
    tw.submit(_check("q0", grp[7]), t)
    tw.submit({"op": "check", "id": "drain", "kind": "drain"}, t)
    tw.pump(t + 0.001)
    tw.submit(_check("shed", grp[0]), t + 0.002)
    # overload on a small queue, hint included
    tw2 = Twin(F=256, batch_cap=64, max_queue=2)
    for i in range(3):
        tw2.submit(_check(f"ol{i}", grp[i]), 9.0)
    tw2.tick(9.001)
    return tw, tw2


def _all_pairs(scenario):
    tw, tw2 = scenario
    return tw.pairs + tw2.pairs


def test_every_reply_matches(scenario):
    pairs = _all_pairs(scenario)
    assert len(pairs) >= 40
    for label, rj, rt in pairs:
        for f in FIELDS:
            if f == "final_count" and rj.get("valid") is not True:
                continue      # engines differ on a dead frontier's count
            if f in rj or f in rt:
                assert rj.get(f) == rt.get(f), (label, f, rj, rt)


def test_scenario_reaches_every_path(scenario):
    """The scenario is not vacuous: each kind answers, with verdicts of
    both signs where the kind has them."""
    by = {str(label): rt for label, _, rt in _all_pairs(scenario)}
    assert by["full0"]["batched"] == 4
    assert by["expire"]["cause"] == "deadline"
    assert by["trivial"]["valid"] is True
    assert str(by["malformed"]["cause"]).startswith("malformed")
    assert by["host"]["degraded"] is True
    assert by["txn-clean"]["valid"] is True
    assert by["txn-g2_item"]["valid"] is False
    assert by["wl-bank_wrong_total"]["valid"] is False
    assert by["wl-sets_lost"]["valid"] is False
    assert by["shrink"]["valid"] is False
    assert by["shrink"]["minimal_ops"] < by["shrink"]["seed_ops"]
    assert by["restore"]["migrated"] is True
    assert by["close"]["valid"] is True
    assert by["bad0"]["valid"] is False and by["latched"]["latched"]
    assert by["q0"]["error"] == "shutting-down"
    assert by["shed"]["error"] == "shutting-down"
    assert by["ol2"]["error"] == "overload"
    assert any(rt.get("valid") is False for label, _, rt
               in _all_pairs(scenario) if str(label).startswith(("full",
                                                                 "dl")))


def test_admission_counters_match(scenario):
    for tw in scenario:
        sj, st = tw.j.status(), tw.t.status()
        for k in COUNTERS:
            assert sj[k] == st[k], (k, sj[k], st[k])
        assert st["carry_reuses"] == 0
        assert set(sj["buckets"]) == set(st["buckets"])
        for key, bj in sj["buckets"].items():
            bt = st["buckets"][key]
            for f in ("requests", "dispatches", "batched"):
                assert bj[f] == bt[f], (key, f)


def test_metrics_scrape_mirrors_the_counters(scenario):
    tw, _ = scenario
    snap = tw.t.metrics_reply(rid=7)
    assert snap["id"] == 7
    jm = tw.j.metrics_reply()["metrics"]
    tm = snap["metrics"]
    for k in COUNTERS:
        name = f"service_{k}_total"
        assert jm[name] == tm[name], name
    assert "compile_kernel_builds_total" in snap["prometheus"]
    assert 'compile_kernel_launches_total{kernel="seg_search_stream"}' \
        in snap["prometheus"]


# --- bucketing -------------------------------------------------------------------

def test_bucket_for_sweep():
    rng = random.Random(1234)
    lim_j, lim_t = JBK.ServiceLimits(max_ops=100), TBK.ServiceLimits(
        max_ops=100)
    seen = set()
    for i in range(40):
        h = register_history(rng, rng.randint(1, 6), rng.randint(2, 120),
                             p_info=rng.choice((0.0, 0.1)),
                             max_pending=rng.randint(1, 4))
        bj = JBK.bucket_for(jax_pack(list(h)), lim_j)
        bt = TBK.bucket_for(torch_pack(list(h)), lim_t)
        assert (bj is None) == (bt is None)
        if bj is not None:
            assert tuple(bj) == tuple(bt) and bj.key == bt.key
            seen.add(bt.key)
        else:
            seen.add(None)
    assert len(seen) > 5 and None in seen


def test_txn_and_wl_bucket_for_sweep():
    lim_j, lim_t = JBK.ServiceLimits(), TBK.ServiceLimits()
    for n in (0, 1, 15, 16, 17, 100, 1023, 1024, 4096, 4097):
        bj = JBK.txn_bucket_for(n, lim_j)
        bt = TBK.txn_bucket_for(n, lim_t)
        assert (bj is None) == (bt is None)
        if bj is not None:
            assert bj.key == bt.key
    from comdb2_tpu.ops.native_loader import parse_history_fast as jparse

    for fam, name, wl in (("bank", "bank_valid", {"n": 8, "total": 160}),
                          ("sets", "sets_lost", None),
                          ("dirty", "dirty_dirty", None)):
        text = _read("wl", f"{name}.edn")
        bj = JBK.wl_bucket_for(fam, jparse(text), wl)
        bt = TBK.wl_bucket_for(fam, parse_history_fast(text), wl)
        assert bj.key == bt.key and bj.model_key == bt.model_key
        assert TBK.wl_dims_of(bt) == JBK.wl_dims_of(bj)


# --- metrics plane ---------------------------------------------------------------

def _registry_calls(mod):
    r = mod.Registry()
    r.counter("service_accepted_total", help="admitted").inc(3)
    r.counter("compile_kernel_launches_total", kernel="a").value = 9
    r.gauge("service_queue_depth").set(4)
    r.gauge("service_bucket_occupancy", bucket="n16").set(0.25)
    h = r.histogram("service_latency_ms", help="wall")
    for v in (0.5, 1.0, 3.0, 7.5, 120.0, 9e4):
        h.observe(v)
    r.histogram("sessions_per_dispatch", buckets=(1.0, 2.0, 4.0)) \
        .observe(3.0)
    return r


def test_metrics_exposition_byte_equal():
    rj, rt = _registry_calls(JMET), _registry_calls(TMET)
    assert rt.render_prometheus() == rj.render_prometheus()
    assert rt.snapshot() == rj.snapshot()


# --- stage tiling and priming ----------------------------------------------------

def test_stages_tile_the_latency():
    core = TCore(F=256, batch_cap=8, device="cpu")
    rng = random.Random(5)
    now = tobs.monotonic()
    for i in range(6):
        core.submit(_check(i, register_history(rng, 3, 30, p_info=0.0)),
                    now)
    done = core.tick()
    assert len(done) == 6
    for _, r in done:
        total = sum(r["stages"].values())
        assert abs(total - r["latency_ms"]) <= max(
            0.1 * r["latency_ms"], 1.0), r
    st = core.status()
    assert st["device"] == "cpu"
    assert st["stage_ms"]["device"]["n"] == 6


def test_prime_dispatches_and_counts_nothing_served():
    core = TCore(device="cpu")
    n = core.prime()
    assert n == core.m["primed"] > 0
    assert core.m["completed"] == 0 and core.m["engine_errors"] == 0


def test_a_failed_dispatch_answers_unknown_with_its_cause(monkeypatch):
    """Engine errors answer ``unknown`` with an ``engine:`` cause and
    count ``engine_errors`` (as in the JAX package); nothing re-routes
    to the host engine."""
    from comdb2_tpu_torch.checker import batch as TB

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(TB, "check_batch_async", boom)
    core = TCore(F=256, batch_cap=8, device="cpu")
    core.submit(_check(1, register_history(random.Random(3), 3, 20,
                                           p_info=0.0)), 0.0)
    (_, r), = core.tick(0.001)
    assert r["valid"] == "unknown"
    assert r["cause"].startswith("engine: RuntimeError")
    assert core.m["engine_errors"] == 1 and core.m["host_degraded"] == 0
    with pytest.raises(RuntimeError, match="priming dispatch failed"):
        TCore(device="cpu").prime()


def test_no_card_no_core():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCore()


def test_compile_guard_window(monkeypatch):
    """The kernel counters the service scrapes: a window sees only its
    own builds, launches and variants; ``assert_closed`` raises on a
    variant outside the declared set (a ``None`` layout admits any).
    On CPU tensors nothing launches, so the launches are noted here as
    the wrappers note them on the card."""
    from comdb2_tpu_torch.utils import compile_guard as CG

    monkeypatch.setattr(CG, "KERNEL_BUILDS", CG.KERNEL_BUILDS)
    monkeypatch.setattr(CG, "LAUNCHES", dict(CG.LAUNCHES))
    monkeypatch.setattr(CG, "VARIANTS", dict(CG.VARIANTS))
    CG.note_launch("pair_sort", 4096)               # before the window
    with CG.guard() as g:
        CG.note_build()
        CG.note_launch("seg_search_stream", (6, 8, 2))
        CG.note_launch("seg_search_stream", (6, 8, 2))
        CG.note_launch("seg_search", (2, 2, 1))
    assert g.counters() == {"kernel_builds": 1, "launches": {
        "seg_search": 1, "seg_search_stream": 2, "pair_sort": 0}}
    assert g.variants() == {("seg_search_stream", (6, 8, 2)): 2,
                            ("seg_search", (2, 2, 1)): 1}
    g.assert_closed({("seg_search_stream", None),
                     ("seg_search", (2, 2, 1))})
    with pytest.raises(CG.CompileSurfaceError, match="seg_search"):
        g.assert_closed({("seg_search_stream", (6, 8, 2))})
    # the core scrapes the process-wide values
    core = TCore(device="cpu")
    text = core.metrics_reply()["prometheus"]
    assert "compile_kernel_builds_total " + str(CG.KERNEL_BUILDS) in text
    assert 'compile_kernel_launches_total{kernel="pair_sort"} ' \
        f'{CG.LAUNCHES["pair_sort"]}' in text
