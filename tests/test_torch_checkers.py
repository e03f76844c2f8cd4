"""The port's checker layer (``comdb2_tpu_torch.checker.checkers``,
``independent``, ``workloads``, ``wgl``, ``utils.intervals`` and
``filetest --checker``) against the JAX package's.

The same inputs go to both packages; the result maps must be equal,
with ops compared by their maps (the two packages' ``Op`` classes
differ). Linearizability and serializability run on CPU tensors
(``device="cpu"``). No tolerance: every value compared is a bool, an
int, a float computed the same way, or a string.
"""

import os
import random

import pytest
import torch

from comdb2_tpu import filetest as jax_filetest
from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.checker import wgl as JWGL
from comdb2_tpu.checker import workloads as JWK
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.utils import intervals as JINT

from comdb2_tpu_torch import filetest
from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.checker import wgl as TWGL
from comdb2_tpu_torch.checker import workloads as TWK
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.history import history_to_edn
from comdb2_tpu_torch.utils import intervals as TINT

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TEST = {"name": "t"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """Ops as their maps and models as their descriptions, so results
    compare across the packages' classes."""
    if hasattr(x, "to_map") and hasattr(x, "process"):
        return x.to_map()
    if hasattr(x, "describe"):
        return x.describe()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _both(build):
    """``build(O, key)`` with each package's op module and keyed-tuple
    constructor: the same history in both packages' classes."""
    return build(TO, TI.tuple_), build(JO, JI.tuple_)


# --- merge_valid / compose / check_safe --------------------------------------

@pytest.mark.parametrize("valids", [
    [], [True, True], [True, "unknown"], [True, "unknown", False],
    ["crashed", True], [None], [False, "unknown"]])
def test_merge_valid(valids):
    assert TC.merge_valid(valids) == JC.merge_valid(valids)


def test_compose_and_check_safe():
    class Always:
        def __init__(self, v):
            self.v = v

        def check(self, test, model, history, opts=None):
            return {"valid?": self.v}

    class Boom:
        def check(self, test, model, history, opts=None):
            raise ValueError("kaboom")

    cmap = {"a": Always(True), "b": Always("unknown"), "c": Always(False)}
    for sub in ({"a": cmap["a"]}, {"a": cmap["a"], "b": cmap["b"]}, cmap):
        assert TC.compose(sub).check(TEST, None, []) == \
            JC.compose(sub).check(TEST, None, [])
    t = TC.compose({"ok": Always(True), "boom": Boom()}).check(TEST, None, [])
    j = JC.compose({"ok": Always(True), "boom": Boom()}).check(TEST, None, [])
    assert t["valid?"] == j["valid?"] == "unknown"
    assert "kaboom" in t["boom"]["error"]
    assert TC.unbridled_optimism.check(TEST, None, []) == \
        JC.unbridled_optimism.check(TEST, None, [])


# --- set / queue / total-queue / counter -------------------------------------

def _set_history(O, k, lose=False, phantom=False, read=True):
    h = []
    for v in range(12):
        h.append(O.invoke(v, "add", v))
        h.append((O.ok if v % 4 else O.info)(v, "add", v))
    back = [v for v in range(12) if v % 4 or v == 8]
    if lose:
        back.remove(5)
    if phantom:
        back.append(40)
    if read:
        h += [O.invoke(99, "read", None), O.ok(99, "read", tuple(back))]
    return h


@pytest.mark.parametrize("kw", [{}, {"lose": True}, {"phantom": True},
                                {"lose": True, "phantom": True},
                                {"read": False}])
def test_set_checker(kw):
    h, jh = _both(lambda O, k: _set_history(O, k, **kw))
    assert TC.set_checker.check(TEST, None, h) == \
        JC.set_checker.check(TEST, None, jh)


def _queue_history(O, k, bad=False, drain=True):
    h = []
    for v in range(6):
        h += [O.invoke(0, "enqueue", v), O.ok(0, "enqueue", v)]
    h += [O.invoke(1, "enqueue", 6), O.info(1, "enqueue", 6)]
    outs = list(range(6 if drain else 3)) + ([2, 77] if bad else [])
    for v in outs:
        h += [O.invoke(2, "dequeue", None), O.ok(2, "dequeue", v)]
    return h


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("drain", [False, True])
def test_queue_and_total_queue(bad, drain):
    h, jh = _both(lambda O, k: _queue_history(O, k, bad, drain))
    assert _plain(TC.queue.check(TEST, TM.unordered_queue(), h)) == \
        _plain(JC.queue.check(TEST, JM.unordered_queue(), jh))
    assert TC.total_queue.check(TEST, None, h) == \
        JC.total_queue.check(TEST, None, jh)


@pytest.mark.parametrize("high", [False, True])
def test_counter_checker(high):
    def build(O, k):
        h = [O.invoke(0, "add", 3), O.ok(0, "add", 3),
             O.invoke(1, "read", None), O.invoke(0, "add", 4),
             O.ok(1, "read", 10 if high else 5), O.ok(0, "add", 4),
             O.invoke(1, "read", None), O.ok(1, "read", 7)]
        return h

    h, jh = _both(build)
    got = TC.counter.check(TEST, None, h)
    assert got == JC.counter.check(TEST, None, jh)
    assert got["valid?"] is (not high)


# --- workloads: bank / dirty reads / G2 and the graph second opinions --------

def _g2_history(O, key, doubled):
    h = []
    for k in range(3):
        h += [O.invoke(0, "insert", key(k, (10 + k, None))),
              O.ok(0, "insert", key(k, (10 + k, None))),
              O.invoke(1, "insert", key(k, (None, 20 + k))),
              (O.ok if k in doubled else O.fail)(
                  1, "insert", key(k, (None, 20 + k)))]
    return h


@pytest.mark.parametrize("doubled", [(), (1,), (0, 2)])
def test_g2_checker_and_its_composed_second_opinion(doubled):
    h, jh = _both(lambda O, key: _g2_history(O, key, doubled))
    assert TWK.g2_checker.check(TEST, None, h) == \
        JWK.g2_checker.check(TEST, None, jh)
    got = TWK.g2_composed().check(TEST, None, h)
    assert _plain(got) == _plain(JWK.g2_composed().check(TEST, None, jh))
    assert got["valid?"] is (not doubled)
    assert got["graph"]["valid?"] is got["adya"]["valid?"]


def _dirty_history(O, k, dirty):
    h = [O.invoke(0, "write", 3), (O.fail if dirty else O.ok)(0, "write", 3),
         O.invoke(0, "write", 4), O.ok(0, "write", 4),
         O.invoke(1, "read", None), O.ok(1, "read", (3, 3, 4)),
         O.invoke(1, "read", None), O.ok(1, "read", (4, 4, 4))]
    return h


@pytest.mark.parametrize("dirty", [False, True])
def test_dirty_reads_checker_and_its_composed_second_opinion(dirty):
    h, jh = _both(lambda O, k: _dirty_history(O, k, dirty))
    assert TWK.dirty_reads_checker.check(TEST, None, h) == \
        JWK.dirty_reads_checker.check(TEST, None, jh)
    got = TWK.dirty_reads_composed().check(TEST, None, h)
    assert _plain(got) == \
        _plain(JWK.dirty_reads_composed().check(TEST, None, jh))
    assert got["valid?"] is (not dirty)


@pytest.mark.parametrize("row", [(4, 6), (4, 5), (10,)])
def test_bank_checker(row):
    h, jh = _both(lambda O, k: [O.invoke(0, "read", None),
                                O.ok(0, "read", row)])
    model = {"n": 2, "total": 10}
    assert _plain(TWK.bank_checker.check(TEST, model, h)) == \
        _plain(JWK.bank_checker.check(TEST, model, jh))


@pytest.mark.parametrize("x", [[1, [2, 3]], {"a": [1]}, {1, 2}, (4,), 5])
def test_freeze_value(x):
    assert TWK.freeze_value(x) == JWK.freeze_value(x)


@pytest.mark.parametrize("xs", [set(), {7}, {1, 2, 3, 5, 9, 10},
                                {-2, -1, 0, 4}, {"a", 1}, {None, 2}])
def test_intervals(xs):
    assert TINT.integer_interval_set_str(xs) == \
        JINT.integer_interval_set_str(xs)
    assert TINT.fraction(len(xs), 3) == JINT.fraction(len(xs), 3)
    assert TINT.fraction(1, 0) == JINT.fraction(1, 0)


# --- Serializable / Linearizable objects --------------------------------------

@pytest.mark.parametrize("kind", ["clean", "g1c", "g2-item"])
def test_serializable_checker(kind):
    got = TC.Serializable(backend="device", device="cpu").check(
        TEST, None, TS.txn_anomaly_history(kind))
    assert got == JC.Serializable(backend="device").check(
        TEST, None, JS.txn_anomaly_history(kind))
    assert TC.Serializable(adapter=lambda ops: [], device="cpu").check(
        TEST, None, []) == JC.Serializable(adapter=lambda ops: []).check(
        TEST, None, [])


@pytest.mark.parametrize("seed", [0, 1])
def test_linearizable_checker(seed):
    rng = random.Random(seed)
    h = TS.register_history(rng, n_procs=3, n_events=40, values=3)
    if seed:
        h = TS.mutate(rng, h)
    jh = [JO.Op(**{f: getattr(op, f) for f in
                   ("process", "type", "f", "value")}) for op in h]
    got = TC.Linearizable(backend="host", device="cpu").check(
        TEST, TM.cas_register(), h)
    want = JC.Linearizable(backend="host").check(
        TEST, JM.cas_register(), jh)
    assert got["valid?"] == want["valid?"]
    assert got.get("op-index") == want.get("op-index")


# --- IndependentChecker --------------------------------------------------------

def _keyed_history(O, key, n_keys=4, bad=(2,)):
    """Each key a 3-process register history of its own (ids apart),
    interleaved round-robin; the keys in ``bad`` mutated, plus one
    un-keyed nemesis op."""
    per = []
    for k in range(n_keys):
        rng = random.Random(50 + k)
        h = JS.register_history(rng, n_procs=3, n_events=30, values=3,
                                p_info=0.0)
        if k in bad:
            h = JS.mutate(rng, h)
        per.append([O.Op(op.process + 10 * k, op.type, op.f,
                         key(k, op.value)) for op in h])
    out = [O.info("nemesis", "start", None)]
    for i in range(max(map(len, per))):
        out += [h[i] for h in per if i < len(h)]
    return out


@pytest.mark.parametrize("bad", [(), (2,), (0, 3)])
def test_independent_checker(bad):
    h, jh = _both(lambda O, key: _keyed_history(O, key, bad=bad))
    assert TI.history_keys(h) == JI.history_keys(jh) == [0, 1, 2, 3]
    subs = TI.subhistories(TI.history_keys(h), h)
    for k in range(4):
        assert _plain(subs[k]) == _plain(TI.subhistory(k, h)) == \
            _plain(JI.subhistory(k, jh))
    got = TI.IndependentChecker(TC.Linearizable(device="cpu")).check(
        TEST, TM.cas_register(), h)
    want = JI.IndependentChecker(JC.Linearizable()).check(
        TEST, JM.cas_register(), jh)
    assert got["valid?"] == want["valid?"]
    assert got["failures"] == want["failures"]
    assert {k: (r["valid?"], r.get("op-index"))
            for k, r in got["results"].items()} == \
        {k: (r["valid?"], r.get("op-index"))
         for k, r in want["results"].items()}
    assert got["valid?"] is (not bad)


def test_independent_checker_goes_through_one_batch_launch(monkeypatch):
    from comdb2_tpu_torch.checker import batch as TB

    calls = []
    real = TB.check_batch

    def spy(pb, **kw):
        calls.append((len(pb), kw.get("device")))
        return real(pb, **kw)

    monkeypatch.setattr(TB, "check_batch", spy)
    h = _keyed_history(TO, TI.tuple_, bad=())
    r = TI.IndependentChecker(TC.Linearizable(device="cpu")).check(
        TEST, TM.cas_register(), h)
    assert calls == [(4, "cpu")]
    assert all(v == {"valid?": True, "backend": "device-batch"}
               for v in r["results"].values())


def test_independent_checker_errors_it_does_not_swallow(monkeypatch):
    """A device fault propagates, whatever its type (no route raises
    ``EngineNotPorted`` any more, and nothing is caught for it); a
    malformed key re-checks each key alone; ``mesh=``, which raised
    until it was ported, gives the JAX package's answer over its CPU
    mesh."""
    from comdb2_tpu_torch.checker import batch as TB

    h = _keyed_history(TO, TI.tuple_, bad=(1,))
    lin = TC.Linearizable(device="cpu")

    def fault(pb, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(TB, "check_batch", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TI.IndependentChecker(lin).check(TEST, TM.cas_register(), h)

    def not_ported(pb, **kw):
        raise NotImplementedError("flat")

    monkeypatch.setattr(TB, "check_batch", not_ported)
    with pytest.raises(NotImplementedError):
        TI.IndependentChecker(lin).check(TEST, TM.cas_register(), h)

    monkeypatch.setattr(TB, "check_batch", fault)
    torn = h + [TO.ok(999, "read", TI.tuple_(0, 1))]   # ok without invoke
    r = TI.IndependentChecker(lin).check(TEST, TM.cas_register(), torn)
    assert r["results"][0]["valid?"] == "unknown"
    monkeypatch.undo()

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from comdb2_tpu_torch.service.sharding import make_mesh

    got = TI.IndependentChecker(lin, mesh=make_mesh(2, device="cpu")).check(
        TEST, TM.cas_register(), h)
    jh = _keyed_history(JO, JI.tuple_, bad=(1,))
    want = JI.IndependentChecker(
        JC.Linearizable(),
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("batch",))).check(
        TEST, JM.cas_register(), jh)
    assert got["valid?"] == want["valid?"] is False
    assert got["failures"] == want["failures"] == [1]
    assert {k: v["valid?"] for k, v in got["results"].items()} == \
        {k: v["valid?"] for k, v in want["results"].items()}


# --- wgl -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wgl_analysis(seed):
    rng = random.Random(seed)
    h = JS.register_history(rng, n_procs=3, n_events=30, values=3)
    if seed % 2:
        h = JS.mutate(rng, h)
    th = [TO.Op(op.process, op.type, op.f, op.value) for op in h]
    got = TWGL.analysis(TM.cas_register(), th, n_threads=1)
    assert got == JWGL.analysis(JM.cas_register(), h, n_threads=1)
    assert TWGL.analysis(TM.cas_register(), th)["valid?"] == got["valid?"]


# --- filetest --checker ------------------------------------------------------

def _filetest_cases():
    cases = [([f"{FIX}/txn/{n}.edn", "--txn"], rc)
             for n, rc in (("clean", 0), ("g1c", 1), ("g2_item", 1))]
    cases += [([f"{FIX}/txn/g2_item.edn", "--checker", "txn", "--backend",
                "device", "--realtime"], 1)]
    for name, fam, rc in (("bank_valid", "bank", 0),
                          ("bank_wrong_total", "bank", 1),
                          ("sets_valid", "sets", 0), ("sets_lost", "sets", 1),
                          ("dirty_valid", "dirty", 0),
                          ("dirty_dirty", "dirty", 1)):
        extra = ["--wl-n", "8", "--wl-total", "160"] if fam == "bank" else []
        cases.append(([f"{FIX}/wl/{name}.edn", "--checker", fam] + extra, rc))
        cases.append(([f"{FIX}/wl/{name}.edn", "--checker", fam,
                       "--backend", "host"] + extra, rc))
    return cases


@pytest.mark.parametrize("argv,rc", _filetest_cases())
def test_filetest_exit_codes_equal_the_reference(argv, rc, capsys):
    assert filetest.main(argv + ["--device", "cpu"]) == rc
    assert jax_filetest.main(argv) == rc
    capsys.readouterr()


@pytest.mark.parametrize("checker", ["set", "wgl", "linear"])
@pytest.mark.parametrize("mutated", [False, True])
def test_filetest_set_wgl_linear_on_a_register_history(tmp_path, capsys,
                                                       checker, mutated):
    rng = random.Random(21)
    h = TS.register_history(rng, n_procs=3, n_events=40, values=3)
    if mutated:
        h = TS.mutate(rng, h)
    if checker == "set":
        h = _set_history(TO, None, lose=mutated)
    p = tmp_path / "h.edn"
    p.write_text(history_to_edn(h))
    argv = [str(p), "--checker", checker]
    rc = jax_filetest.main(argv)
    assert filetest.main(argv + ["--device", "cpu"]) == rc
    capsys.readouterr()


def test_filetest_bank_needs_its_model(capsys):
    with pytest.raises(SystemExit):
        filetest.main([f"{FIX}/wl/bank_valid.edn", "--checker", "bank",
                       "--device", "cpu"])
    capsys.readouterr()
