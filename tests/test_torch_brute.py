"""The port's exhaustive oracle (``checker/brute.py``) and history
helpers (``ops.history.pairs`` / ``pair_index`` / ``processes``)
against the JAX package's.

Tiny histories (3 processes, 8-10 events, some with info ops, some
mutated) enumerated from seeds: ``brute_valid`` agrees with the JAX
package's ``brute_valid`` and with the port's host search
(``linear_host``); the pairing helpers give equal results, and raise
alike on a history that breaks the single-threaded process discipline.
"""

import random

import pytest

from comdb2_tpu.checker.brute import brute_valid as jax_brute
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import history as JH
from comdb2_tpu.ops import synth as JS

from comdb2_tpu_torch import ops as TOPS
from comdb2_tpu_torch.checker import linear_host
from comdb2_tpu_torch.checker.brute import brute_valid
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.models.memo import memo
from comdb2_tpu_torch.ops import history as TH
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops.packed import pack_history

SEEDS = range(24)


def _tiny(seed):
    rng = random.Random(seed)
    h = JS.register_history(rng, n_procs=3, n_events=8 + seed % 3,
                            values=3, p_info=0.15 if seed % 4 == 0 else 0.0)
    return JS.mutate(rng, h, values=3) if seed % 2 else h


@pytest.mark.parametrize("seed", SEEDS)
def test_brute_valid_matches(seed):
    h = _tiny(seed)
    for model in ("cas_register", "register"):
        want = jax_brute(getattr(JM, model)(), h)
        assert brute_valid(getattr(TM, model)(), h) == want
        if model == "cas_register":
            packed = pack_history(h)
            r = linear_host.check(memo(TM.cas_register(), packed), packed)
            assert r.valid == want


def test_brute_sees_both_verdicts():
    verdicts = {jax_brute(JM.cas_register(), _tiny(s)) for s in SEEDS}
    assert verdicts == {True, False}


@pytest.mark.parametrize("seed", range(8))
def test_pairs_pair_index_and_processes_match(seed):
    h = JH.complete(_tiny(seed), index=True)
    assert TOPS.processes(h) == JH.processes(h)
    assert TOPS.pairs(h) == JH.pairs(h)
    assert TH.pair_index(h) == JH.pair_index(h)


@pytest.mark.parametrize("bad", [
    [TO.invoke(0, "write", 1), TO.invoke(0, "write", 2)],
    [TO.ok(0, "write", 1)],
])
def test_pairs_raise_alike(bad):
    h = [op.with_(index=i) for i, op in enumerate(bad)]
    with pytest.raises(RuntimeError):
        JH.pairs(h)
    with pytest.raises(RuntimeError):
        TH.pairs(h)
    if bad[0].type == "ok":
        with pytest.raises(RuntimeError):
            TH.pair_index(h)
