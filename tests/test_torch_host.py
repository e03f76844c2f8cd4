"""Host modules of the PyTorch/CUDA port against the JAX package: the
same seeded histories must pack, memoize, segment and slot-rename to
byte-equal arrays and equal tables, and the EDN round trip and host
engine must agree."""

import random

import numpy as np
import pytest

import comdb2_tpu.checker.linear_jax as LJ
from comdb2_tpu.checker import linear_host as JH
from comdb2_tpu.models import model as JM
from comdb2_tpu.models.memo import memo as jax_memo
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.history import parse_history as jax_parse
from comdb2_tpu.ops.packed import pack_history as jax_pack

from comdb2_tpu_torch.checker import linear_host as TH
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.models.memo import memo as torch_memo
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.history import history_to_edn, parse_history
from comdb2_tpu_torch.ops.packed import pack_history

# the families of tests/test_remap_slots.py: (n_procs, n_events,
# p_info, max_pending, mutate)
FAMILIES = [
    (10, 400, 0.0, 3, False),
    (8, 300, 0.1, 4, False),
    (6, 200, 0.1, 3, False),
    (4, 60, 0.0, 2, True),
    (8, 200, 0.15, 3, True),
    (12, 240, 0.0, 3, True),
    (16, 300, 0.0, 4, False),
    (3, 40, 0.05, None, False),
]

ARRAYS = ("process", "type", "f", "value", "trans", "pair", "fails",
          "time")
TABLES = ("process_table", "f_table", "value_table", "transition_table")


def _history(seed, fam):
    n_procs, n_events, p_info, max_pending, mut = fam
    h = JS.register_history(random.Random(seed), n_procs=n_procs,
                            n_events=n_events, p_info=p_info,
                            max_pending=max_pending)
    if mut:
        h = JS.mutate(random.Random(seed + 1), h)
    return h


@pytest.mark.parametrize("fam", FAMILIES)
def test_synth_matches_draw_for_draw(fam):
    n_procs, n_events, p_info, max_pending, _ = fam
    kw = dict(n_procs=n_procs, n_events=n_events, p_info=p_info,
              max_pending=max_pending)
    a = JS.register_history(random.Random(5), **kw)
    b = TS.register_history(random.Random(5), **kw)
    assert [(o.process, o.type, o.f, o.value) for o in a] == \
        [(o.process, o.type, o.f, o.value) for o in b]
    ma = JS.mutate(random.Random(6), a, values=3)
    mb = TS.mutate(random.Random(6), b, values=3)
    assert [o.value for o in ma] == [o.value for o in mb]


@pytest.mark.parametrize("fam", FAMILIES)
def test_pack_and_memo_byte_equal(fam):
    h = _history(11, fam)
    edn = history_to_edn(h)
    pj = jax_pack(jax_parse(edn))
    pt = pack_history(parse_history(edn))
    for name in ARRAYS:
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in TABLES:
        assert getattr(pj, name) == getattr(pt, name), name
    mj = jax_memo(JM.cas_register(), pj)
    mt = torch_memo(TM.cas_register(), pt)
    assert mj.succ.dtype == mt.succ.dtype
    assert mj.succ.tobytes() == mt.succ.tobytes()
    assert [s.describe() for s in mj.states] == \
        [s.describe() for s in mt.states]


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("pads", [(None, None), (128, 8)])
def test_segments_and_remap_byte_equal(fam, pads):
    h = _history(23, fam)
    s_pad, k_pad = pads
    sj = LJ.make_segments(jax_pack(h), s_pad=s_pad, k_pad=k_pad)
    st = LT.make_segments(pack_history(h), s_pad=s_pad, k_pad=k_pad)
    for a, b in zip(sj, st):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    rj, pj_, oj = LJ.remap_slots(sj, with_maps=True)
    rt, pt_, ot = LT.remap_slots(st, with_maps=True)
    assert pj_ == pt_
    assert oj.tobytes() == ot.tobytes()
    for a, b in zip(rj, rt):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert LT.remap_slots(st)[1] == pt_


def test_remap_error_paths_match():
    segs = LT.SegmentStream(
        inv_proc=np.array([[0], [0]], np.int32),
        inv_tr=np.zeros((2, 1), np.int32),
        ok_proc=np.full(2, -1, np.int32),
        seg_index=np.zeros(2, np.int64),
        depth=np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="still open"):
        LT.remap_slots(segs)
    orphan = LT.SegmentStream(
        inv_proc=np.full((2, 1), -1, np.int32),
        inv_tr=np.zeros((2, 1), np.int32),
        ok_proc=np.array([0, -1], np.int32),
        seg_index=np.zeros(2, np.int64),
        depth=np.zeros(2, np.int32))
    a = LT.remap_slots(orphan)
    b = LJ.remap_slots(LJ.SegmentStream(*orphan))
    assert a[1] == b[1] == 1
    assert a[0].ok_proc.tolist() == b[0].ok_proc.tolist()


@pytest.mark.parametrize("seed", range(6))
def test_host_engine_matches(seed):
    fam = FAMILIES[seed % len(FAMILIES)]
    h = _history(100 + seed, fam)
    pj, pt = jax_pack(h), pack_history(h)
    try:
        rj = JH.check(jax_memo(JM.cas_register(), pj), pj,
                      max_configs=1 << 12)
    except JH.FrontierOverflow:
        with pytest.raises(TH.FrontierOverflow):
            TH.check(torch_memo(TM.cas_register(), pt), pt,
                     max_configs=1 << 12)
        return
    rt = TH.check(torch_memo(TM.cas_register(), pt), pt,
                  max_configs=1 << 12)
    assert (rj.valid, rj.op_index, rj.final_count, rj.max_frontier) == \
        (rt.valid, rt.op_index, rt.final_count, rt.max_frontier)
    assert rj.configs == rt.configs and rj.pre_configs == rt.pre_configs


def test_malformed_history_errors_match():
    from comdb2_tpu.ops import op as JO
    from comdb2_tpu_torch.ops import op as TO

    for mk in (JO, TO):
        h = [mk.invoke(0, "write", 1), mk.invoke(0, "write", 2)]
        with pytest.raises(RuntimeError, match="already running"):
            (jax_pack if mk is JO else pack_history)(h)


def test_models_catalog_matches():
    assert sorted(JM.MODELS) == sorted(TM.MODELS)
    for name in JM.MODELS:
        assert repr(JM.MODELS[name]()) == repr(TM.MODELS[name]())


def test_convert_carries_the_jax_arrays_across():
    import torch

    from comdb2_tpu_torch import convert

    h = _history(41, FAMILIES[1])
    pj = jax_pack(h)
    segs = LJ.make_segments(pj, k_pad=4)
    st = convert.segment_tensors(segs, "cpu")
    for a, t in zip(segs, st):
        assert t.dtype == torch.from_numpy(np.asarray(a)).dtype
        assert t.numpy().tobytes() == np.asarray(a).tobytes()
    mj = jax_memo(JM.cas_register(), pj)
    assert convert.succ_tensor(mj, "cpu").numpy().tobytes() == \
        mj.succ.tobytes()
    assert LT.pad_succ(mj.succ, 8, 64).tobytes() == \
        LJ.pad_succ(mj.succ, 8, 64).tobytes()
    assert LT.estimated_cost([0, 1, 3, 13]) == \
        LJ.estimated_cost([0, 1, 3, 13])


def test_trace_records_the_check_spans():
    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.obs import trace

    h = TS.register_history(random.Random(2), n_procs=3, n_events=200,
                            p_info=0.0)
    before = len(trace.spans())
    trace.enable()
    try:
        a = analysis(TM.cas_register(), h, backend="device",
                     device="cpu")
    finally:
        trace.disable()
    names = [s.name for s in trace.spans()[before:]]
    assert a.valid is True
    assert {"linear.analysis", "linear.pack", "linear.device"} <= \
        set(names)
    new = trace.spans()[before:]
    assert all(s.t1 >= s.t0 for s in new)
    analysis(TM.cas_register(), h, backend="device", device="cpu")
    assert len(trace.spans()) == before + len(new)    # disabled: no-op
