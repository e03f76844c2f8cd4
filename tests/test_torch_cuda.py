"""The port's CUDA kernel on the card against its plain PyTorch version.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports nothing of JAX, so it runs on a card host that has no
JAX installed, without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from comdb2_tpu_torch.checker import analysis
from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.models.memo import memo
from comdb2_tpu_torch.models.model import cas_register
from comdb2_tpu_torch.ops.packed import pack_history
from comdb2_tpu_torch.ops.synth import mutate, register_history

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (n_procs, max_pending, mutate): 2-word and 3-word tiers, valid,
# invalid and overflowing histories
CASES = [(5, None, False), (5, None, True), (10, 5, False),
         (10, 5, True), (10, 10, False), (6, 4, True)]


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda, case):
    n_procs, mp, mut = case
    rng = random.Random(600 + CASES.index(case))
    h = register_history(rng, n_procs=n_procs, n_events=2000, values=5,
                         p_info=0.0, max_pending=mp)
    if mut:
        h = mutate(rng, h, values=5)
    packed = pack_history(h)
    mm = memo(cas_register(), packed)
    segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
    p = max(p, 1)
    spec = SK.spec_for(mm.n_states, mm.n_transitions, p, 8)
    seg = torch.from_numpy(SK.pack_segments(segs, spec)).to(cuda)
    ws = torch.from_numpy(SK.initial_frontier(spec)).to(cuda)
    stat = torch.from_numpy(SK._init_stat()).to(cuda)
    table = torch.from_numpy(SK.pack_table(mm.succ)).to(cuda)
    before = SK.LAUNCHES
    got = SK.seg_search(seg, 0, mm.n_transitions, ws, stat, table, spec)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == before + 1
    want = SK.seg_search_reference(seg, 0, mm.n_transitions, ws, stat,
                                   table, spec)
    assert SK.LAUNCHES == before + 1
    assert got[:2] == want[:2]
    if got[0] != SK.UNKNOWN:
        assert got[2] == want[2]
        assert SK.decode_frontier(spec, got[3], p) == \
            SK.decode_frontier(spec, want[3], p)


@pytest.mark.parametrize("seed", range(3))
def test_analysis_on_the_card_matches_cpu(cuda, seed):
    rng = random.Random(40 + seed)
    h = register_history(rng, n_procs=5, n_events=3000, values=5,
                         p_info=0.0)
    if seed:
        h = mutate(rng, h, values=5)
    a = analysis(cas_register(), h, device="cuda")
    b = analysis(cas_register(), h, device="cpu")
    assert a.info["engine"] == "cuda-seg"
    assert (a.valid, a.op_index, a.final_count, a.configs,
            a.info.get("paths")) == \
        (b.valid, b.op_index, b.final_count, b.configs,
         b.info.get("paths"))


def test_chunked_boundary_on_the_card_matches_cpu(cuda):
    rng = random.Random(8)
    for _ in range(20):
        h = mutate(rng, register_history(rng, n_procs=5, n_events=3000,
                                         values=5, p_info=0.0), values=5)
        packed = pack_history(h)
        mm = memo(cas_register(), packed)
        segs, p = LT.remap_slots(LT.make_segments(packed, k_pad=8))
        kw = dict(n_states=mm.n_states, n_transitions=mm.n_transitions,
                  P=max(p, 1), return_boundary=True, chunk=64)
        got = SK.check_device_seg_kernel_chunked(mm.succ, segs,
                                                 device="cuda", **kw)
        want = SK.check_device_seg_kernel_chunked(mm.succ, segs,
                                                  device="cpu", **kw)
        if want[0] == SK.INVALID:
            break
    assert got[:3] == want[:3] and want[0] == SK.INVALID
    spec = SK.spec_for(mm.n_states, mm.n_transitions, max(p, 1), 8)
    assert got[3][1] == want[3][1]
    assert SK.decode_frontier(spec, got[3][0], p) == \
        SK.decode_frontier(spec, want[3][0], p)
