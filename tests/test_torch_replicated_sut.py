"""The port's replicated-cluster clients and control plane
(``comdb2_tpu_torch.workloads.tcp``: ``TcpClusterRegisterClient``,
``ClusterControl``, ``ClusterPartitioner``, ``ClusterClockScrambler``,
``spawn_cluster``) against the JAX package's — the mirror of
``tests/test_replicated_sut.py``.

Request bytes: each package's client or control object talks to its
own three scripted line servers (``torch_cluster_parity.LineServer``)
with the same replies; the lines each server receives, the
completions and the values returned must be equal, through the
cluster client's retry-elsewhere rotation and the control plane's
best-effort verbs alike. The client's per-session nonce is drawn from
the OS in both packages, so both are given the same one.

Verdicts: the reference's runs against a live ``sut_node`` cluster
through the port's ``harness.core.run``; each history goes through the
port's checker and, as the JAX package's ops, through the JAX
package's: the result maps must be equal
(``torch_harness_parity.plain``). VALID runs must be VALID and the
controls (``-B`` split brain, ``-N`` no durability, ``-D`` no dedup,
``-L`` bad lease) INVALID through both packages' ``Linearizable``.
Linearizability runs on the host engine, as in the reference test.

Shortened against the reference (which takes 147 s together with its
crash-restart file on one core): the partitioned runs last 3.5 s
instead of 4 s, the failover, split-brain, clock and five-node runs 4.5
s instead of 6 s (windows of 1.5 s instead of 2 s), the split-brain and
no-durable controls try three seeds instead of four, and the HA-driver
run is 4 s of ``ct_register`` instead of 8 s and the discovery run 3 s
instead of 6 s; every assertion is kept.
"""

import random
import subprocess
import threading
import time

import pytest

from comdb2_tpu.checker import analysis as janalysis
from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.models.model import cas_register as jcas_register
from comdb2_tpu.ops import kv as JKV
from comdb2_tpu.ops.history import parse_history as jparse
from comdb2_tpu.workloads import tcp as JT

from comdb2_tpu_torch.checker import analysis as tanalysis
from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import fake as TFAKE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import kv as TKV
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops.history import parse_history as tparse
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads import tcp as TT

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)

TIMEOUT = 0.2
SESSION = 0x5EED


# --- request bytes: the cluster register client -------------------------------

def _cluster_responder(scenario, i):
    """Server ``i``'s answers in ``scenario``."""
    def respond(line):
        mutation = line.startswith("M ")
        if scenario == "first-silent" and i == 0:
            return CP.SILENT
        if scenario == "first-closed" and i == 0:
            return CP.CLOSE
        if scenario == "first-truncated" and i == 0:
            return CP.Truncated("OK")
        if scenario == "all-silent":
            return CP.SILENT
        if not mutation:
            return {"fail": "ERR no leader"}.get(scenario, "V 2")
        return {"ok": "OK 5", "fail": "FAIL", "unknown": "UNKNOWN",
                "first-unknown": "UNKNOWN" if i == 0 else "OK 7"
                }.get(scenario, "OK 5")
    return respond


CLUSTER_SCENARIOS = ["ok", "fail", "unknown", "first-unknown",
                     "first-silent", "first-closed", "first-truncated",
                     "all-silent"]
CLUSTER_OPS = {"read": ("read", (2, None)), "write": ("write", (2, 4)),
               "cas": ("cas", (2, (4, 1)))}


def _cluster_once(T, kv, scenario, op_name, retries):
    with CP.line_servers([_cluster_responder(scenario, i)
                          for i in range(3)]) as servers:
        proto = T.TcpClusterRegisterClient([s.port for s in servers],
                                           timeout_s=TIMEOUT,
                                           mutate_retries=retries)
        c = proto.setup({}, None)
        c._session = SESSION
        f, (k, v) = CLUSTER_OPS[op_name]
        try:
            done = [c.invoke({}, {"type": "invoke", "f": f,
                                  "value": kv.tuple_(k, v), "process": 3})
                    for _ in range(2)]
        finally:
            c.teardown({})
        return CP.recorded(servers), done, c._port_ix, c._seq


@pytest.mark.parametrize("op_name", list(CLUSTER_OPS))
@pytest.mark.parametrize("scenario", CLUSTER_SCENARIOS)
def test_cluster_client_request_bytes_and_completions(scenario, op_name):
    """Two ops on one client: the nonce-wrapped lines, the rotation
    over the nodes, the retry budget and the completions."""
    got = _cluster_once(TT, TKV, scenario, op_name, 3)
    want = _cluster_once(JT, JKV, scenario, op_name, 3)
    assert got[0] == want[0]
    assert P.plain(got[1]) == P.plain(want[1])
    assert got[2:] == want[2:]


def test_cluster_client_clones_cycle_the_nodes():
    """Each worker's clone takes the next node, in both packages."""
    got, want = [], []
    for T, out in ((TT, got), (JT, want)):
        with CP.line_servers([lambda line: "V 1"] * 3) as servers:
            proto = T.TcpClusterRegisterClient([s.port for s in servers])
            clones = [proto.setup({}, n) for n in range(5)]
            out += [(c._port_ix, c.mutate_retries, c.timeout_s)
                    for c in clones]
            for c in clones:
                c.teardown({})
    assert got == want == [(i % 3, 3, 1.0) for i in range(5)]


# --- request bytes: the control plane ----------------------------------------

def _control_responder(scenario, i):
    def respond(line):
        if scenario == "one-down" and i == 2:
            return CP.CLOSE
        if line == "I":
            role = "primary" if i == (1 if scenario == "moved" else 0) \
                else "replica"
            applied = 9 if scenario != "lagging" or i != 2 else 4
            if scenario == "old-info":
                return f"I {i} {role} {applied} {applied}"
            return f"I {i} {role} {applied} {applied} 3 0"
        if line.startswith("K ") and scenario == "clock-refused":
            return "ERR no"
        return "OK"
    return respond


CONTROL_SCENARIOS = ["up", "moved", "one-down", "lagging", "old-info",
                     "clock-refused"]


def _control_once(T, scenario, action):
    with CP.line_servers([_control_responder(scenario, i)
                          for i in range(3)]) as servers:
        ctl = T.ClusterControl([s.port for s in servers],
                               timeout_s=TIMEOUT)
        if action == "info":
            # each package has its own servers: name them by index
            ports = [s.port for s in servers]
            out = [{**d, "port": ports.index(d["port"])}
                   for d in ctl.info()]
        elif action == "primary":
            out = ctl.primary()
        elif action == "partition-heal":
            out = (ctl.partition([0], [1, 2]), ctl.heal())
        elif action == "clock":
            out = (ctl.clock(1, -60_000), ctl.clocks_reset())
        elif action == "await":
            out = ctl.await_replicated(timeout_s=0.3)
        elif action == "partitioner":
            nem = T.ClusterPartitioner(ctl, rng=random.Random(71))
            out = [nem.invoke({}, {"type": "info", "f": f})
                   for f in ("start", "stop", "start")]
            nem.teardown({})
        elif action == "isolate":
            nem = T.ClusterPartitioner(ctl, isolate_primary=True)
            out = [nem.invoke({}, {"type": "info", "f": f})
                   for f in ("start", "stop")]
        else:
            nem = T.ClusterClockScrambler(ctl, rng=random.Random(61))
            out = [nem.invoke({}, {"type": "info", "f": f})
                   for f in ("start", "stop")]
            nem.teardown({})
        # the control plane opens one connection per request: compare
        # each server's lines in the order they came
        return [(i, [line for _, line in s.lines])
                for i, s in enumerate(servers)], out


@pytest.mark.parametrize("action", ["info", "primary", "partition-heal",
                                    "clock", "await", "partitioner",
                                    "isolate", "scrambler"])
@pytest.mark.parametrize("scenario", CONTROL_SCENARIOS)
def test_control_plane_requests_and_answers(scenario, action):
    got = _control_once(TT, scenario, action)
    want = _control_once(JT, scenario, action)
    assert got == want


# --- the reference's runs against a live cluster ------------------------------

def _cluster_test(tmp_path, ports, name, **kw):
    t = TFAKE.noop_test(device="cpu")
    t.update({
        "nodes": [], "concurrency": 5, "name": name,
        "store-root": str(tmp_path / "store"),
        "client": TT.TcpClusterRegisterClient(ports, timeout_s=0.45),
        "model": TM.cas_register(),
        "generator": TG.clients(TG.limit(120, TG.mix([TW.r, TW.w,
                                                      TW.cas]))),
        "checker": TI.checker(TC.Linearizable(backend="host",
                                              device="cpu")),
    })
    t.update(kw)
    return t


def _held(result, tmp_path):
    """The port's result equals the JAX package's checker's on the same
    history; returns the port's results."""
    want = JI.checker(JC.Linearizable(backend="host")).check(
        {"name": "jax", "dir": str(tmp_path / "jax")}, jcas_register(),
        P.to_jax(result["history"]))
    assert P.plain(result["results"]) == P.plain(want)
    return result["results"]


N_KEYS = 8


def _keyed(f, seed):
    """Ops over N_KEYS registers, each process from its own rng derived
    from (seed, process, f), as in the reference."""
    rngs = {}

    def op(test=None, process=None):
        rng = rngs.get(process)
        if rng is None:
            rng = rngs[process] = random.Random(f"{seed}/{process}/{f}")
        k = rng.randrange(N_KEYS)
        if f == "read":
            return {"type": "invoke", "f": "read",
                    "value": TKV.tuple_(k, None)}
        if f == "write":
            return {"type": "invoke", "f": "write",
                    "value": TKV.tuple_(k, rng.randrange(5))}
        return {"type": "invoke", "f": "cas",
                "value": TKV.tuple_(k, (rng.randrange(5),
                                        rng.randrange(5)))}
    return op


def _nemesis_gen(seed, secs=3.5, window=1.0, lead=0.3, gap=0.6,
                 cycles=2):
    kr, kw, kc = (_keyed("read", seed), _keyed("write", seed),
                  _keyed("cas", seed))
    steps = [TG.sleep(lead)]
    for _ in range(cycles):
        steps += [{"type": "info", "f": "start"}, TG.sleep(window),
                  {"type": "info", "f": "stop"}, TG.sleep(gap)]
    return TG.nemesis(
        TG.seq(steps),
        TG.time_limit(secs, TG.stagger(0.01, TG.mix([kr, kr, kw, kc]))))


def _req(port, line, timeout=1.5):
    conn = TT.SutConnection("127.0.0.1", port, timeout_s=timeout)
    try:
        conn.connect()
        return conn.request(line)
    except TimeoutError:
        return "TIMEOUT"
    finally:
        conn.close()


@CP.needs_sut_node
def test_cluster_discovery_and_replication():
    """Both packages' control planes read the same cluster the same
    way."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True,
                    timeout_ms=800) as (ports, _):
        info = TT.ClusterControl(ports).info()
        assert [n["role"] for n in info] == ["primary", "replica",
                                             "replica"]
        assert TT.ClusterControl(ports).primary() == 0
        assert JT.ClusterControl(ports).info() == info


@CP.needs_sut_node
def test_durable_cluster_valid_without_faults(tmp_path):
    with CP.cluster(TT.spawn_cluster, 3, durable=True,
                    timeout_ms=800) as (ports, _):
        result = TCORE.run(_cluster_test(tmp_path, ports,
                                         "cluster-register"))
    res = _held(result, tmp_path)
    assert res["valid?"] is True, res
    assert len([op for op in result["history"] if op.type == "ok"]) >= 60


@CP.needs_sut_node
def test_durable_cluster_valid_under_partition(tmp_path):
    """Master-targeted partitions: writes that cannot reach a majority
    time out into info ops; the history stays linearizable (seed 11)."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True,
                    timeout_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        try:
            result = TCORE.run(_cluster_test(
                tmp_path, ports, "cluster-nemesis-durable",
                nemesis=TT.ClusterPartitioner(ctl, isolate_primary=True),
                generator=_nemesis_gen(seed=11)))
        finally:
            ctl.heal()
    res = _held(result, tmp_path)
    assert res["valid?"] is True, ("seed 11", res)
    assert [op for op in result["history"]
            if op.type == "info" and op.process != "nemesis"], \
        "partition should have produced indeterminate ops"


@CP.needs_sut_node
def test_partition_forces_election_and_demotion():
    """Cutting the primary off elects a new leader on the majority side
    while the old primary demotes and refuses its stale state."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=400,
                    elect_ms=500, lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        assert _req(ports[1], "W 1 42").startswith("OK")
        ctl.partition([0], [1, 2])
        try:
            new_leader = CP.wait_until(
                lambda: next((n for n in ctl.info()
                              if n["role"] == "primary"
                              and n["node"] != 0), None), 6.0)
            assert new_leader is not None, "no election happened"
            assert new_leader["term"] > 1
            assert _req(ports[new_leader["node"]],
                        "W 1 77").startswith("OK")
            assert _req(ports[0], "R 1", timeout=1.2) in ("UNKNOWN",
                                                          "TIMEOUT")
        finally:
            ctl.heal()
        assert ctl.await_replicated(timeout_s=8.0)
        assert _req(ports[0], "R 1") == "V 77"


def _window_writes(h):
    """ok writes and cas invoked over 1 s into a partition window and
    completed inside it (only a newly elected leader can ack them)."""
    starts = [op.time for op in h
              if op.process == "nemesis" and op.f == "start"
              and op.type == "info" and op.value is not None]
    stops = [op.time for op in h
             if op.process == "nemesis" and op.f == "stop"
             and op.type == "info" and op.value is None]
    assert starts, "nemesis never fired"
    pairs, rerouted = {}, 0
    for op in h:
        if op.process == "nemesis" or op.f not in ("write", "cas"):
            continue
        if op.type == "invoke":
            pairs[op.process] = op.time
        elif op.type == "ok":
            t0 = pairs.get(op.process)
            if t0 is None:
                continue
            for s in starts:
                stop = min((e for e in stops if e > s), default=None)
                if stop and t0 > s + 1.0e9 and op.time < stop:
                    rerouted += 1
    return rerouted


@CP.needs_sut_node
def test_durable_cluster_valid_through_failover(tmp_path):
    """A partition window longer than an election re-routes writes to
    the new leader inside the window; the history over two leaderships
    stays linearizable (seed 23)."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=300,
                    elect_ms=500, lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        try:
            result = TCORE.run(_cluster_test(
                tmp_path, ports, "cluster-failover",
                nemesis=TT.ClusterPartitioner(ctl, isolate_primary=True),
                generator=_nemesis_gen(seed=23, secs=4.5, window=1.5,
                                       lead=0.4, gap=0.8)))
            terms = [n.get("term", 1) for n in ctl.info()
                     if n["role"] != "down"]
        finally:
            ctl.heal()
    res = _held(result, tmp_path)
    assert res["valid?"] is True, ("seed 23", res)
    assert max(terms) > 1, "partition never forced an election"
    assert _window_writes(result["history"]) > 0, \
        "no write completed ok inside a partition window"


def _control_run(tmp_path, name, seeds, spawn_kw, gen_kw):
    """The first seed whose run both packages' checkers find INVALID,
    or None."""
    for seed in seeds:
        with CP.cluster(TT.spawn_cluster, 3, **spawn_kw) as (ports, _):
            ctl = TT.ClusterControl(ports)
            try:
                result = TCORE.run(_cluster_test(
                    tmp_path, ports, f"{name}-{seed}",
                    nemesis=TT.ClusterPartitioner(ctl,
                                                  isolate_primary=True),
                    generator=_nemesis_gen(seed=seed, **gen_kw)))
            finally:
                ctl.heal()
        if _held(result, tmp_path)["valid?"] is False:
            return seed
    return None


@CP.needs_sut_node
def test_no_durable_partition_detected_invalid(tmp_path):
    """Negative control: acks before replication (``-N``); a partitioned
    replica serves stale reads, INVALID through both packages."""
    seeds = [31, 32, 33]
    assert _control_run(tmp_path, "cluster-nodurable", seeds,
                        dict(durable=False), {}) is not None, \
        f"no-durable cluster never caught (seeds {seeds})"


@CP.needs_sut_node
def test_split_brain_control_detected_invalid(tmp_path):
    """Negative control: with ``-B`` a leader that loses quorum neither
    demotes nor waits for majority acks: divergent states, INVALID
    through both packages."""
    seeds = [41, 42, 43]
    assert _control_run(
        tmp_path, "cluster-splitbrain", seeds,
        dict(durable=True, timeout_ms=300, elect_ms=500, lease_ms=300,
             flags=["-B"]),
        dict(secs=4.5, window=1.5, lead=0.4, gap=0.8)) is not None, \
        f"split-brain control never caught (seeds {seeds})"


@CP.needs_sut_node
def test_replication_protocol_certifies_before_counting():
    """Acks carry the certified prefix, never raw applied: two scripted
    leaders against one real node (``_wait_ready`` of the port)."""
    ports = CP.free_ports(3)
    proc = subprocess.Popen(
        [CP.SUT_NODE, "-i", "1", "-n", ",".join(map(str, ports)),
         "-t", "300", "-e", "60000", "-l", "300"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        TT._wait_ready(proc, ports[1], time.monotonic() + 5.0, "sut_node")
        conn = CP.connect(TT.SutConnection, ports[1], timeout=1.0)
        try:
            assert conn.request("H 0 5 0") == "A 0"
            assert conn.request("E 0 5 1 5 0 W 1 7 0 0 0") == "A 1"
            assert conn.request("E 0 5 1 5 0 W 1 7 0 0 0") == "A 1"
            assert conn.request("H 2 7 0") == "A 0"
            assert conn.request("E 2 7 1 7 0 W 1 9 0 0 0") == "A 1"
            assert conn.request("H 2 7 1") == "A 1"
            info = conn.request("I").split()
            assert info[2] == "replica" and int(info[3]) == 1
            assert conn.request("S") == "UNKNOWN"
        finally:
            conn.close()
    finally:
        CP.kill([proc])


@CP.needs_sut_node
def test_wait_ready_raises_when_the_node_dies_at_startup():
    """A node that exits at startup (here: a flag it refuses): both
    packages' ``_wait_ready`` raise the same error."""
    port = CP.free_ports(1)[0]
    out = []
    for T in (TT, JT):
        proc = subprocess.Popen([CP.SUT_NODE, "--no-such-flag"],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            with pytest.raises(RuntimeError) as e:
                T._wait_ready(proc, port, time.monotonic() + 5.0,
                              "sut_node")
            out.append(str(e.value))
        finally:
            CP.kill([proc])
    assert out[0] == out[1] == f"sut_node on port {port} exited rc=2 " \
                               f"at startup"


@CP.needs_sut_node
def test_dedup_replays_recorded_outcome():
    """A nonce-wrapped mutation that applied returns its recorded
    outcome on retry; the cas does not re-execute."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True,
                    timeout_ms=800) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            r1 = conn.request("M 901 W 1 5")
            assert r1.startswith("OK")
            assert conn.request("M 901 W 1 5") == r1
            r2 = conn.request("M 902 C 1 5 6")
            assert r2.startswith("OK")
            assert conn.request("M 902 C 1 5 6") == r2
            assert conn.request("R 1") == "V 6"
            assert conn.request("M 903 C 1 99 7") == "FAIL"
            assert conn.request("M 903 C 1 6 7").startswith("OK")
            assert conn.request("R 1") == "V 7"
        finally:
            conn.close()


@CP.needs_sut_node
def test_no_dedup_retried_cas_double_applies():
    """``-D``: a replayed cas re-executes and fails though it applied."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=800,
                    flags=["-D"]) as (ports, _):
        conn = CP.connect(TT.SutConnection, ports[0])
        try:
            assert conn.request("M 901 W 1 5").startswith("OK")
            assert conn.request("M 902 C 1 5 6").startswith("OK")
            assert conn.request("M 902 C 1 5 6") == "FAIL"
            assert conn.request("R 1") == "V 6"
        finally:
            conn.close()


def _both_analyses(ops_t):
    """The port's ``analysis`` on the host engine, and the JAX
    package's on the same ops: (port valid, JAX valid)."""
    got = tanalysis(TM.cas_register(), ops_t, backend="host",
                    device="cpu")
    want = janalysis(jcas_register(), P.to_jax(ops_t), backend="host")
    return got.valid, want.valid


@CP.needs_sut_node
def test_ha_driver_few_infos_under_partitions(tmp_path):
    """``ct_register`` over a partitioned cluster, the port's control
    plane cycling the partitions: mostly ok / fail (the nonce retry
    resolves fault-window ops), and the history linearizable through
    both packages. 4 s of driver instead of the reference's 8 s; the
    bounds are the reference's."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=400,
                    elect_ms=500, lease_ms=300) as (ports, _):
        nodes = ",".join(f"127.0.0.1:{p}" for p in ports)
        ctl = TT.ClusterControl(ports)
        stop = threading.Event()

        def nemesis():
            while not stop.wait(0.8):
                pri = ctl.primary()
                if pri is None:
                    continue
                ctl.partition([pri], [i for i in range(3) if i != pri])
                if stop.wait(1.2):
                    break
                ctl.heal()

        th = threading.Thread(target=nemesis)
        th.start()
        out = tmp_path / "ha_dedup.edn"
        try:
            p = subprocess.run(
                [CP.CT_REGISTER, "-T", "4", "-r", "4", "-d", nodes, "-j",
                 str(out), "-s", "77"],
                capture_output=True, text=True, timeout=120)
            assert p.returncode == 0, p.stderr
        finally:
            stop.set()
            th.join(timeout=10)
            ctl.heal()
    assert not th.is_alive()
    text = out.read_text()
    h = tparse(text)
    assert [P.op_fields(o) for o in P.to_jax(h)] == \
        [P.op_fields(o) for o in jparse(text)]
    counts = {}
    for op in h:
        counts[op.type] = counts.get(op.type, 0) + 1
    n_ops, n_info = counts.get("invoke", 0), counts.get("info", 0)
    assert n_ops >= 200, counts
    assert n_info <= max(10, n_ops // 20), counts
    assert _both_analyses(h) == (True, True)


@CP.needs_sut_node
def test_no_dedup_cluster_detected_invalid():
    """The ``-D`` control, deterministic: a cas delivered in a partition
    blip is retried after the heal. With dedup the retry replays OK
    (VALID); without it the retry FAILs though the first applied
    (INVALID), through both packages."""
    def run_once(no_dedup):
        with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=300,
                        elect_ms=3000, lease_ms=300,
                        flags=["-D"] if no_dedup else []) as (ports, _):
            ctl = TT.ClusterControl(ports)
            conn = CP.connect(TT.SutConnection, ports[0])
            try:
                assert conn.request("W 1 5").startswith("OK")
                ctl.partition([0], [1, 2])
                r1 = conn.request("M 77 C 1 5 6")
                assert r1 == "UNKNOWN", r1
                ctl.heal()
                assert ctl.await_replicated(timeout_s=8.0)
                return (conn.request("M 77 C 1 5 6"),
                        conn.request("R 1"))
            finally:
                conn.close()
                ctl.heal()

    def verdict(cas_outcome, read_reply):
        val = (None if read_reply == "NIL"
               else int(read_reply.split()[1]))
        h = [TO.Op(process=0, type="invoke", f="write", value=5, time=0),
             TO.Op(process=0, type="ok", f="write", value=5, time=1),
             TO.Op(process=1, type="invoke", f="cas", value=(5, 6), time=2),
             TO.Op(process=1, type=cas_outcome, f="cas", value=(5, 6),
                   time=3),
             TO.Op(process=2, type="invoke", f="read", value=None, time=4),
             TO.Op(process=2, type="ok", f="read", value=val, time=5)]
        return _both_analyses(h)

    r2, r3 = run_once(no_dedup=False)
    assert r2.startswith("OK"), r2
    assert r3 == "V 6", r3
    assert verdict("ok", r3) == (True, True)
    r2, r3 = run_once(no_dedup=True)
    assert r2 == "FAIL", r2
    assert r3 == "V 6", r3
    assert verdict("fail", r3) == (False, False)


@CP.needs_sut_node
def test_clock_scrambler_harmless_against_monotonic_leases(tmp_path):
    """Scrambled wall clocks with partitions in the same windows: the
    monotonic-lease cluster stays linearizable (seed 61)."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=300,
                    elect_ms=500, lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        part = TT.ClusterPartitioner(ctl, isolate_primary=True)
        clock = TT.ClusterClockScrambler(ctl, rng=random.Random(61))

        class Both:
            def setup(self, test, node):
                return self

            def teardown(self, test):
                part.teardown(test)
                clock.teardown(test)

            def invoke(self, test, op):
                clock.invoke(test, op)
                return part.invoke(test, op)

        try:
            result = TCORE.run(_cluster_test(
                tmp_path, ports, "cluster-clock-scramble", nemesis=Both(),
                generator=_nemesis_gen(seed=61, secs=4.5, window=1.5,
                                       lead=0.4, gap=0.7)))
        finally:
            ctl.clocks_reset()
            ctl.heal()
    res = _held(result, tmp_path)
    assert res["valid?"] is True, ("seed 61", res)
    assert any(op.process == "nemesis" and op.f == "start"
               and op.value for op in result["history"])


@CP.needs_sut_node
def test_bad_lease_clock_fault_serves_stale_read():
    """``-L``: a backward clock jump on a partitioned leader stretches
    its dead lease, so it serves a stale register after the majority
    commits a new value; the correct cluster answers UNKNOWN. The
    resulting history is INVALID through both packages."""
    def run_once(bad_lease):
        with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=400,
                        elect_ms=500, lease_ms=300,
                        flags=["-L"] if bad_lease else []) as (ports, _):
            ctl = TT.ClusterControl(ports)
            try:
                assert _req(ports[0], "W 1 5").startswith("OK")
                ctl.partition([0], [1, 2])
                assert ctl.clock(0, -60_000), "clock command never landed"
                new_leader = CP.wait_until(
                    lambda: next((n["node"] for n in ctl.info()
                                  if n["role"] == "primary"
                                  and n["node"] != 0), None), 6.0)
                assert new_leader is not None, "no election"
                assert _req(ports[new_leader], "W 1 7").startswith("OK")
                stale = _req(ports[0], "R 1", timeout=1.2)
                assert _req(ports[new_leader], "R 1") == "V 7"
                return stale
            finally:
                ctl.clocks_reset()
                ctl.heal()

    assert run_once(bad_lease=False) in ("UNKNOWN", "TIMEOUT")
    stale = run_once(bad_lease=True)
    assert stale == "V 5", stale
    h = [TO.Op(process=0, type="invoke", f="write", value=5, time=0),
         TO.Op(process=0, type="ok", f="write", value=5, time=1),
         TO.Op(process=1, type="invoke", f="write", value=7, time=2),
         TO.Op(process=1, type="ok", f="write", value=7, time=3),
         TO.Op(process=2, type="invoke", f="read", value=None, time=4),
         TO.Op(process=2, type="ok", f="read", value=7, time=5),
         TO.Op(process=3, type="invoke", f="read", value=None, time=6),
         TO.Op(process=3, type="ok", f="read", value=5, time=7)]
    assert _both_analyses(h) == (False, False)


@CP.needs_sut_node
def test_five_node_cluster_breaknet_failover(tmp_path):
    """Five nodes with the breaknet shape {master, +1} against the other
    three: the majority elects and serves, the history stays
    linearizable (seed 71) and the cluster converges after the heal."""
    with CP.cluster(TT.spawn_cluster, 5, durable=True, timeout_ms=300,
                    elect_ms=500, lease_ms=300) as (ports, _):
        ctl = TT.ClusterControl(ports)
        try:
            result = TCORE.run(_cluster_test(
                tmp_path, ports, "cluster-5node-breaknet", concurrency=7,
                nemesis=TT.ClusterPartitioner(ctl, rng=random.Random(71)),
                generator=_nemesis_gen(seed=71, secs=4.5, window=1.5,
                                       lead=0.4, gap=0.8)))
            terms = [n.get("term", 1) for n in ctl.info()
                     if n["role"] != "down"]
        finally:
            ctl.heal()
        converged = ctl.await_replicated(timeout_s=10.0)
    res = _held(result, tmp_path)
    assert res["valid?"] is True, ("seed 71", res)
    assert max(terms) > 1, "breaknet never forced an election"
    assert len([op for op in result["history"] if op.type == "ok"]) >= 100
    assert converged


@CP.needs_sut_node
def test_ha_client_comdb2db_discovery(tmp_path):
    """``ct_register`` resolves ``@<cfgfile>#<dbname>`` to the cluster
    the port spawned; its history is linearizable through both packages,
    and an unknown dbname fails fast."""
    with CP.cluster(TT.spawn_cluster, 3, durable=True, timeout_ms=400,
                    elect_ms=500, lease_ms=300) as (ports, _):
        cfg = tmp_path / "comdb2db.cfg"
        cfg.write_text(
            "# comdb2db-style cluster config\n"
            "otherdb 10.0.0.1:1 10.0.0.2:1\n"
            + "testdb " + " ".join(f"127.0.0.1:{p}" for p in ports) + "\n")
        out = tmp_path / "disc.edn"
        p = subprocess.run(
            [CP.CT_REGISTER, "-T", "3", "-r", "3", "-d", f"@{cfg}#testdb",
             "-j", str(out), "-s", "5"],
            capture_output=True, text=True, timeout=60)
        assert p.returncode == 0, p.stderr
        p2 = subprocess.run(
            [CP.CT_REGISTER, "-T", "1", "-r", "2", "-d",
             f"@{cfg}#nosuchdb", "-j", str(tmp_path / "x.edn")],
            capture_output=True, text=True, timeout=30)
        assert p2.returncode != 0
    h = tparse(out.read_text())
    assert sum(1 for op in h if op.type == "ok") >= 20
    assert _both_analyses(h) == (True, True)
