"""The frozen generators: the same seed gives the same inputs, and they
draw as the port's own ``ops/synth.py`` does."""

import json
import os
import random

import pytest

from conftest import ROOT
from perfbench.gen import pool, register


@pytest.mark.parametrize("kw", [
    dict(n_procs=5, n_events=600, values=5, p_info=0.0),
    dict(n_procs=5, n_events=600, values=5,
         fs=("write", "cas", "cas", "read"), p_info=0.0),
    dict(n_procs=3, n_events=300, values=3, p_info=0.05),
    dict(n_procs=10, n_events=300, values=5, p_info=0.0, max_pending=5),
])
def test_equal_to_the_ports_generators(kw):
    from comdb2_tpu_torch.ops import synth

    for seed in (0, 7, 2**31 + 11):
        mine = register.register_history(random.Random(seed), **kw)
        theirs = synth.register_history(random.Random(seed), **kw)
        assert mine == [(o.process, o.type, o.f, o.value) for o in theirs]


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_a_planted_read_changes_one_read_in_the_tail(seed):
    h = register.register_history(random.Random(seed), n_procs=5,
                                  n_events=600, values=5, p_info=0.0)
    m, at = register.plant_read(random.Random(seed), h, 5, 0.1)
    assert [i for i, (x, y) in enumerate(zip(h, m)) if x != y] == [at]
    assert at >= 540 and m[at][1:3] == ("ok", "read") and m[at][3] == 5
    assert m == register.plant_read(random.Random(seed), h, 5, 0.1)[0]


def _config(name, **history):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           name + ".json")) as fh:
        c = json.load(fh)
    c["history"] = {**c["history"], **history}
    return c


def test_pools_are_deterministic_per_seed():
    c1 = _config("ctest-register-5t", n_events=800)
    a = pool.single_pool(c1, 8, 2**31 + 5)
    b = pool.single_pool(c1, 8, 2**31 + 5)
    c = pool.single_pool(c1, 8, 2**31 + 6)
    assert [x.history for x in a] == [x.history for x in b]
    assert [x.history for x in a] != [x.history for x in c]
    assert [x.mutated for x in a] == [x.mutated for x in c] == \
        [i == 4 for i in range(8)]
    assert all(len(x.history) == 800 for x in a + c)
    d = pool.single_pool(c1, 8, 2**31 + 5, workers=3)
    assert [x.history for x in a] == [x.history for x in d]
