"""The plain reference: every planted history INVALID at its planted
read, every other VALID, the same verdicts and indices as the port's
host checker, the port's counterexamples borne out and altered ones
not, and closure rounds that are the port's kernel's iterations (the
count the roofline is built on)."""

import json
import os
import random

import pytest

from conftest import ROOT
from perfbench.gen import pool
from perfbench.lib import roofline
from perfbench.reference.linear import check, report_faults


def _config(name, **history):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           name + ".json")) as fh:
        c = json.load(fh)
    c["history"] = {**c["history"], **history}
    return c


def _port_ops(h):
    from comdb2_tpu_torch.ops.op import Op

    return [Op(*e) for e in h]


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_planted_histories_invalid_at_the_read_the_rest_valid(seed):
    from comdb2_tpu_torch.checker import linear_host
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history

    c = _config("ctest-register-5t", n_events=1500)
    items = pool.single_pool(c, 16, seed)
    base = pool.single_pool(dict(c, invalid_share=0.0), 16, seed)
    for it, b in zip(items, base):
        v = check(it.history)
        assert v.valid is (not it.mutated)
        packed = pack_history(_port_ops(it.history))
        r = linear_host.check(memo(cas_register(), packed), packed)
        assert r.valid is v.valid
        if it.mutated:
            (at,) = [i for i, (x, y) in enumerate(zip(it.history,
                                                      b.history)) if x != y]
            assert at >= 1500 - 150 and it.history[at][2:] == ("read", 5)
            assert v.op_index == r.op_index == at
            assert v.dead and v.open_calls


@pytest.mark.parametrize("history", [
    dict(n_events=1500),
    dict(n_events=300, n_procs=10, fs=["write", "cas", "cas", "read"]),
])
def test_the_ports_counterexamples_are_borne_out(history):
    """Every INVALID history's report from the port (its plain kernel
    versions on CPU, with 10 processes its seg2 ladder) agrees with the
    reference's frontier; each kind of alteration does not."""
    from comdb2_tpu_torch.checker.linear import analysis
    from comdb2_tpu_torch.models.model import cas_register

    c = dict(_config("ctest-register-5t", **history), invalid_share=1.0,
             mutation_tail=0.3)
    for it in pool.single_pool(c, 3, 2**31 + 29):
        v = check(it.history)
        a = analysis(cas_register(), _port_ops(it.history), device="cpu")
        assert (a.valid, a.op_index) == (False, v.op_index)
        paths = a.info["paths"]
        assert report_faults(v, a.configs, paths) == []
        assert len(a.configs) == min(10, len(v.dead))
        assert report_faults(v, [], paths)
        assert report_faults(v, a.configs, [])
        moved = [{**a.configs[0], "model": "CASRegister(value=7)"}]
        assert report_faults(v, moved + a.configs[1:], paths)
        assert report_faults(v, a.configs, [p[:-1] for p in paths])
        wrong_op = [p[:-1] + [{**p[-1], "op": {**p[-1]["op"],
                                               "process": 99}}]
                    for p in paths]
        assert report_faults(v, a.configs, wrong_op)


@pytest.mark.parametrize("n_procs,max_pending", [(5, None), (10, 5)])
def test_rounds_are_the_kernels_iterations(n_procs, max_pending):
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.checker.linear import kernel_slots
    from comdb2_tpu_torch.models.memo import memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.utils import next_pow2
    from perfbench.gen.register import register_history

    h = register_history(random.Random(11), n_procs=n_procs, n_events=600,
                         values=5, p_info=0.0, max_pending=max_pending)
    v = check(h)
    packed = pack_history(_port_ops(h))
    mm = memo(cas_register(), packed)
    segs = LT.make_segments(packed)
    segs = LT.make_segments(packed,
                            s_pad=next_pow2(segs.ok_proc.shape[0], 64),
                            k_pad=next_pow2(segs.inv_proc.shape[1], 2))
    segs, p_eff = LT.remap_slots(segs)
    spec, seg, ws, stat, table = SK._prepare(
        mm.succ, segs, mm.n_states, mm.n_transitions, kernel_slots(p_eff),
        "cpu")
    work = {}
    SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat, table,
                            spec, work=work)
    assert v.valid and p_eff == v.slots
    assert work["keys"] == sum(n * (spec.P + 1) for n in v.rounds)
    assert roofline.needed_compares(v.rounds, spec.P) == \
        SK.needed_compares([n * (spec.P + 1) for n in v.rounds], spec.P)
    ops, nbytes = roofline.need([v])
    assert ops > 0 and nbytes > 4 * 4 * v.segments
