"""The reference suite's one active deftest, ``register-test-nemesis``,
through the port — the mirror of
``tests/test_register_nemesis_cluster.py``.

The port provisions a five-node replicated ``sut_node`` cluster
(``harness.provision.SutNodeDB`` over ``LocalRemote``, ports from the
OS), runs the register workload at concurrency 10 ([w cas cas r]) with
the master+1 breaknet nemesis isolating the primary in two windows
(``workloads.tcp.ClusterPartitioner``), and checks the history with
``compose({perf, timeline, linearizable})``, the linearizability check
being ``IndependentChecker(Linearizable(device="cpu"))``: the lone key
is checked alone through the segment-search kernel's single-history
mode (its plain version here, ``seg-reference``), or the ``torch-seg2``
ladder once fault windows overflow its 128 configs. It must be VALID,
from the device engines, at most 16 effective slots.

The same history then goes through the JAX package's
``independent.checker(Linearizable())``: the verdicts must be equal.
And the port's plain segment search at F = 128 is held against the JAX
package's ``check_device_seg2`` at the same capacity, as the reference
holds its Pallas kernel (not compiled here): equal status and fail
segment, and equal count when VALID.
"""

import pytest

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.checker import linear_jax as LJ
from comdb2_tpu.models.model import cas_register as jcas_register

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.control.remote import LocalRemote
from comdb2_tpu_torch.harness import core as TCORE
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.harness.provision import SutNodeDB, local_layout
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.models.memo import memo as make_memo
from comdb2_tpu_torch.ops.packed import pack_history
from comdb2_tpu_torch.report import Timeline, perf_checker
from comdb2_tpu_torch.utils import next_pow2
from comdb2_tpu_torch.workloads import comdb2 as TW
from comdb2_tpu_torch.workloads.tcp import (ClusterControl,
                                            ClusterPartitioner,
                                            TcpClusterRegisterClient)

import torch_cluster_parity as CP
from torch_cluster_parity import native_build  # noqa: F401 (fixture)
import torch_harness_parity as P

_one_thread = pytest.fixture(autouse=True, scope="module")(
    P.one_torch_thread)


def _tester(tmp_path, nodes, ports, db):
    checker = TC.compose({
        "perf": perf_checker(),
        "timeline": Timeline(),
        "linearizable": TI.checker(TC.Linearizable(device="cpu")),
    })
    # the reference's cycle is 10 s on / 10 s off over 300 s; two ~1 s
    # partition windows in a ~6 s run, as the JAX package's test
    nemesis_steps = [TG.sleep(0.8), {"type": "info", "f": "start"},
                     TG.sleep(1.0), {"type": "info", "f": "stop"},
                     TG.sleep(0.8), {"type": "info", "f": "start"},
                     TG.sleep(1.0), {"type": "info", "f": "stop"}]
    return TW.register_tester_nemesis(opts={
        "nodes": nodes,
        "db": db,
        "store-root": str(tmp_path / "store"),
        "client": TcpClusterRegisterClient(ports, timeout_s=1.0,
                                           mutate_retries=8),
        "nemesis": ClusterPartitioner(ClusterControl(ports),
                                      isolate_primary=True),
        "checker": checker,
        "generator": TG.phases(
            TG.nemesis(
                TG.seq(nemesis_steps),
                TG.time_limit(6.0, TG.stagger(0.02, TG.clients(
                    TG.mix([TW.w, TW.cas, TW.cas, TW.r]))))),
            TG.log("quiesce"),
            TG.sleep(1.0)),
    }, device="cpu")


def _kernel_vs_seg2(history):
    """The port's plain segment search against the JAX package's
    ``check_device_seg2`` at F = 128, at the reference's fixed padded
    spec (segments to a power of two of at least 512, K to 8, slots to
    14, the table to (8, 48)). None when a fault window packed more
    than 8 invokes into one segment (the kernel's K bound)."""
    import numpy as np

    sub = TI.subhistory(1, history)
    packed = pack_history([op for op in sub if op.process != "nemesis"])
    mm = make_memo(TM.cas_register(), packed)
    segs = LT.make_segments(packed)
    K_real = segs.inv_proc.shape[1]
    S_real = segs.ok_proc.shape[0]
    print(f"[flagship] kernel cross-check: K={K_real} S={S_real}")
    if K_real > 8:
        return None
    segs = LT.make_segments(packed, s_pad=next_pow2(S_real, 512), k_pad=8)
    segs, P_eff = LT.remap_slots(segs)
    assert P_eff <= 14, P_eff
    assert mm.n_states <= 8 and mm.n_transitions <= 48, (
        mm.n_states, mm.n_transitions)
    succ_pad = np.full((8, 48), -1, np.int32)
    succ_pad[:mm.n_states, :mm.n_transitions] = mm.succ
    r = SK.check_device_seg_kernel(succ_pad, segs, n_states=8,
                                   n_transitions=48, P=14, device="cpu")
    assert r is not None, "the fixed spec must be kernel-eligible"
    x = LJ.check_device_seg2(
        LJ.pad_succ(succ_pad, 8, 64), segs.inv_proc, segs.inv_tr,
        segs.ok_proc, segs.depth, F=128, Fs=32, P=14, n_states=8,
        n_transitions=48)
    return tuple(int(v) for v in r), tuple(int(v) for v in x)


@CP.needs_sut_node
def test_register_tester_nemesis_end_to_end(tmp_path):
    nodes = ["m1", "m2", "m3", "m4", "m5"]     # the reference's fleet
    ports = CP.free_ports(5)
    db = SutNodeDB(LocalRemote(), CP.SUT_NODE, local_layout(nodes, ports),
                   base_dir=str(tmp_path / "sut"), timeout_ms=300,
                   elect_ms=500, lease_ms=300)
    t = _tester(tmp_path, nodes, ports, db)
    try:
        result = TCORE.run(t)
    finally:
        ClusterControl(ports).heal()
        for node in nodes:
            db.teardown(t, node)
    res = result["results"]
    assert res["valid?"] is True, res
    assert res["linearizable"]["valid?"] is True, res["linearizable"]
    (key_res,) = res["linearizable"]["results"].values()
    assert key_res.get("backend") == "device", key_res
    assert key_res.get("engine") in ("seg-reference", "torch-seg2"), \
        key_res
    assert key_res.get("effective_slots", 99) <= 16, key_res
    history = result["history"]
    assert len([op for op in history if op.type == "ok"
                and op.process != "nemesis"]) >= 80
    assert len([op for op in history if op.process == "nemesis"
                and op.f == "start"]) >= 2, "nemesis never fired"
    assert res["perf"]["valid?"] is True
    assert res["timeline"]["valid?"] is True

    # the JAX package's checker on the same history: the same verdicts
    want = JI.checker(JC.Linearizable()).check(
        {"name": "jax", "dir": str(tmp_path / "jax")}, jcas_register(),
        P.to_jax(history))
    assert want["valid?"] == res["linearizable"]["valid?"]
    assert {k: v["valid?"] for k, v in want["results"].items()} == \
        {k: v["valid?"] for k, v in res["linearizable"]["results"].items()}
    assert want["failures"] == res["linearizable"]["failures"]

    # the plain segment search against the JAX package's seg2 at F = 128
    pair = _kernel_vs_seg2(history)
    if pair is None:
        return
    r, x = pair
    print(f"[flagship] plain kernel={r} seg2@128={x}")
    assert r[0] == x[0], (r, x)
    assert r[1] == x[1], (r, x)
    if r[0] == LT.VALID:
        assert r[2] == x[2], (r, x)
    else:
        # an overflow at 128 in a fault window; the history itself is
        # linearizable (the escalated verdict above)
        assert r[0] == LT.UNKNOWN, r
