"""The port's workload families (``comdb2_tpu_torch.checker.wl``) against
the JAX package's (``comdb2_tpu.checker.wl``).

- Encoders: ``encode_bank`` / ``encode_sets`` / ``encode_dirty`` give
  bit-equal arrays on seeded synth batches and on the fixtures.
- The device programs: the JAX package's encoded columns fed through
  ``convert.wl_columns`` into the port's ``wl_*_check`` give the JAX
  program's outputs, bit for bit, and the port's columns into the JAX
  program give the port's.
- ``check_wl_batch``: lane by lane the JAX package's verdict dicts, per
  family x {valid, each violation} x seeds; the chunking past the top
  batch rung (512) and the host route past a per-history rung.

No tolerance: every value compared is a bool, an int or a string.
"""

import os

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import wl as JW
from comdb2_tpu.checker.wl import batch as JWB
from comdb2_tpu.ops.history import parse_history as jax_parse

from comdb2_tpu_torch import convert
from comdb2_tpu_torch.checker import wl as TW
from comdb2_tpu_torch.checker.wl import batch as TWB
from comdb2_tpu_torch.ops.history import parse_history

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "wl")
VIOLATIONS = {"bank": (None, "total", "n", "snapshot"),
              "sets": (None, "lost", "phantom"),
              "dirty": (None, "dirty", "disagree", "malformed")}
CASES = [(fam, v, seed) for fam, vs in VIOLATIONS.items() for v in vs
         for seed in (3, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """Ops (of either package) as their maps, so verdicts compare across
    the packages' classes."""
    if hasattr(x, "to_map") and hasattr(x, "process"):
        return x.to_map()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _batch(family, seed, violation, n=5, **kw):
    """The same seeded batch from both packages' generators."""
    if family == "bank":
        (h, model), (jh, jmodel) = (
            TW.bank_batch(seed, n, violation=violation, **kw),
            JW.bank_batch(seed, n, violation=violation, **kw))
        assert model == jmodel
        return h, jh, model
    gen = {"sets": (TW.sets_batch, JW.sets_batch),
           "dirty": (TW.dirty_batch, JW.dirty_batch)}[family]
    return (gen[0](seed, n, violation=violation, **kw),
            gen[1](seed, n, violation=violation, **kw), None)


def _encode(W, family, hists, model, dims):
    if family == "bank":
        return W.encode_bank(hists, model, **dims)
    if family == "sets":
        return W.encode_sets(hists, **dims)
    return W.encode_dirty(hists, **dims)


def _program(W, family, dims):
    if family == "bank":
        return lambda *a: W.wl_bank_check(
            *a, n_reads=dims["r_pad"], n_accounts=dims["a_pad"],
            n_snaps=dims["t_pad"])
    if family == "sets":
        return lambda *a: W.wl_sets_check(*a, n_elems=dims["e_pad"])
    return lambda *a: W.wl_dirty_check(
        *a, n_reads=dims["r_pad"], n_nodes=dims["n_pad"],
        n_values=dims["v_pad"])


def _same_columns(cols, jcols):
    assert cols._fields == jcols._fields
    for f in cols._fields:
        a, b = getattr(cols, f), getattr(jcols, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("family,violation,seed", CASES)
def test_check_wl_batch_equals_the_reference_lane_by_lane(family,
                                                         violation, seed):
    h, jh, model = _batch(family, seed, violation)
    before = TWB.DISPATCHES
    got = TW.check_wl_batch(h, family, model, device="cpu")
    assert TWB.DISPATCHES == before + 1
    want = JW.check_wl_batch(jh, family, model)
    assert len(got) == len(want) == len(h)
    for d, w in zip(got, want):
        assert d == w
    # the golden-twin rule against the port's own host oracle
    host = TWB._host_fallback(h, family, model)
    assert all(TWB.agrees_with_oracle(family, d, o, hist)
               for d, o, hist in zip(got, host, h))
    if violation in ("total", "n", "lost", "phantom", "dirty"):
        assert all(d["valid?"] is False for d in got)
    if violation == "malformed":
        assert all(d["valid?"] == "unknown" for d in got)


@pytest.mark.parametrize("family", sorted(VIOLATIONS))
@pytest.mark.parametrize("seed", [5, 6])
def test_encoders_and_programs_bit_equal(family, seed):
    viol = VIOLATIONS[family][1]
    h, jh, model = _batch(family, seed, viol, n=8)
    dims = TW.wl_dims(h, family, model)
    assert dims == JW.wl_dims(jh, family, model)
    cols = _encode(TW, family, h, model, dims)
    jcols = _encode(JW, family, jh, model, dims)
    _same_columns(cols, jcols)
    # the reference's columns into the port's program, and the port's
    # columns into the reference's program
    got = [t.numpy() for t in
           _program(TW, family, dims)(*convert.wl_columns(jcols, "cpu"))]
    want = [np.asarray(x) for x in _program(JW, family, dims)(
        *(getattr(cols, f) for f in
          {"bank": TW.bank, "sets": TW.sets, "dirty": TW.dirty}[family]
          .DEVICE_FIELDS))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name,family,want_rc", [
    ("bank_valid", "bank", 0), ("bank_wrong_total", "bank", 1),
    ("sets_valid", "sets", 0), ("sets_lost", "sets", 1),
    ("dirty_valid", "dirty", 0), ("dirty_dirty", "dirty", 1)])
def test_fixtures_encode_and_check_alike(name, family, want_rc):
    with open(os.path.join(FIXDIR, f"{name}.edn")) as fh:
        text = fh.read()
    h, jh = parse_history(text), jax_parse(text)
    model = {"n": 8, "total": 160} if family == "bank" else None
    dims = TW.wl_dims([h], family, model)
    _same_columns(_encode(TW, family, [h], model, dims),
                  _encode(JW, family, [jh], model, dims))
    got = TW.check_wl_batch([h], family, model, device="cpu")
    assert got == JW.check_wl_batch([jh], family, model)
    assert got[0]["valid?"] is (want_rc == 0)


def test_chunking_past_the_top_batch_rung():
    h = TW.sets_batch(8, 520, n_adds=6, violation="lost")
    jh = JW.sets_batch(8, 520, n_adds=6, violation="lost")
    before = TWB.DISPATCHES
    got = TW.check_wl_batch(h, "sets", device="cpu")
    assert TWB.DISPATCHES == before + 2          # 512 lanes, then 8
    assert got == JW.check_wl_batch(jh, "sets")
    with pytest.raises(ValueError, match="exceeds the top WL_BATCH"):
        TW.stage_wl_batch(h, "sets", device="cpu")


@pytest.mark.parametrize("family,kw", [("dirty", {"n_nodes": 20}),
                                       ("bank", {"n_accounts": 130})])
def test_host_route_past_a_per_history_rung(family, kw):
    h, jh, model = _batch(family, 9, VIOLATIONS[family][1], n=2, **kw)
    assert TW.wl_dims(h, family, model) is None
    before = TWB.DISPATCHES
    got = TW.check_wl_batch(h, family, model, device="cpu")
    assert TWB.DISPATCHES == before
    want = JW.check_wl_batch(jh, family, model)
    assert all(d["engine"] == "host" for d in got)
    assert _plain(got) == _plain(want)
    assert _plain(got) == _plain(JWB._host_fallback(jh, family, model))


def test_bad_arguments_raise_like_the_reference():
    with pytest.raises(ValueError, match="unknown wl family"):
        TW.check_wl_batch([[]], "nope", device="cpu")
    with pytest.raises(ValueError, match="bank needs a model"):
        TW.check_wl_batch([[]], "bank", device="cpu")
    assert TW.check_wl_batch([], "sets", device="cpu") == []


def test_bank_snapshot_match_is_blocked_by_the_element_budget(monkeypatch):
    """A budget smaller than one snapshot's block forces one snapshot
    per block: the same outputs as one block for all."""
    h, _, model = _batch("bank", 10, "snapshot", n=4)
    want = TW.check_wl_batch(h, "bank", model, device="cpu")
    monkeypatch.setattr(TW.bank, "SNAP_BLOCK", 1)
    assert TW.check_wl_batch(h, "bank", model, device="cpu") == want
    assert any(d["snapshot-inconsistent"] for d in want)


def test_check_wl_batch_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    h = TW.sets_batch(1, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.check_wl_batch(h, "sets")


def test_an_empty_read_is_inconsistent_on_the_device_as_in_the_reference():
    """A read of zero node views: the device program (both packages)
    lists it under ``inconsistent-reads`` (its masked max and min never
    meet) where the host oracle does not; ``valid?`` agrees. The port
    keeps the JAX package's device answer."""
    from comdb2_tpu.ops import op as JO

    from comdb2_tpu_torch.ops import op as TO

    h = [TO.invoke(0, "write", 1), TO.ok(0, "write", 1),
         TO.invoke(1, "read", None), TO.ok(1, "read", ())]
    jh = [JO.invoke(0, "write", 1), JO.ok(0, "write", 1),
          JO.invoke(1, "read", None), JO.ok(1, "read", ())]
    got = TW.check_wl_batch([h], "dirty", device="cpu")[0]
    assert got == JW.check_wl_batch([jh], "dirty")[0]
    assert got["inconsistent-reads"] == [()] and got["valid?"] is True
    host = TWB._host_fallback([h], "dirty", None)[0]
    assert host["inconsistent-reads"] == [] and host["valid?"] is True
