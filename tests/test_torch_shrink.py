"""The port's counterexample minimizer (``comdb2_tpu_torch.shrink``, with
``ops.columnar.subset_packed``, ``ops.synth.inject_anomaly``,
``checker.batch.pack_batch_masked`` and ``filetest --shrink``) against
the JAX package's.

The same seeded inputs go to both packages; the port runs on
``device="cpu"`` (the plain versions of its kernels). Both get the same
engine and frontier capacity F, so every candidate's verdict is taken
at the same capacity and the two ddmin trajectories must be the same:
``ShrinkResult`` is compared field for field, ops by their maps. No
tolerance: every compared value is a bool, an int, a string or bytes.
"""

import ast
import os
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from comdb2_tpu import filetest as jax_filetest
from comdb2_tpu.checker import batch as JB
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.columnar import subset_packed as j_subset
from comdb2_tpu.ops.packed import pack_history as j_pack
from comdb2_tpu import shrink as JSH

from comdb2_tpu_torch import filetest
from comdb2_tpu_torch.checker import batch as TB
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.columnar import subset_packed as t_subset
from comdb2_tpu_torch.ops.history import history_to_edn
from comdb2_tpu_torch.ops.packed import pack_history as t_pack
from comdb2_tpu_torch import shrink as TSH

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
F = 64      # every test shape fits; the programs stay small


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(ops):
    return [op.to_map() for op in ops]


def _fields(r):
    """A ShrinkResult as plain values, ops as their maps."""
    return {"checker": r.checker, "valid": r.valid, "ops": _maps(r.ops),
            "seed_ops": r.seed_ops, "n_ops": r.n_ops, "rounds": r.rounds,
            "candidates": r.candidates, "dispatches": r.dispatches,
            "one_minimal": r.one_minimal, "partial": r.partial,
            "extra": r.extra}


def _sig(op):
    return (op.process, op.type, op.f, op.value)


def _seed(kind, n_events, seed=7):
    """``inject_anomaly`` on the base the ground truth is provable for
    (write-only, read-only for lost-update), in both packages."""
    fs = ("read",) if kind == "lost-update" else ("write",)
    out = []
    for S in (TS, JS):
        base = S.register_history(random.Random(seed), 3, n_events, fs=fs,
                                  p_info=0.0)
        out.append(S.inject_anomaly(base, kind))
    return out


# --- atoms, masks, the masked batch ------------------------------------------

@pytest.mark.parametrize("seed,n_procs,p_info", [(0, 4, 0.2), (1, 3, 0.1),
                                                (2, 5, 0.3), (3, 2, 0.0)])
def test_atoms_of_equal_with_info_ops_and_pending_invokes(seed, n_procs,
                                                          p_info):
    ht = TS.register_history(random.Random(seed), n_procs, 80, p_info=p_info)
    hj = JS.register_history(random.Random(seed), n_procs, 80, p_info=p_info)
    # a pending invoke on a fresh process, and one crashed into :info
    ht += [TO.invoke(90, "write", 1), TO.invoke(91, "write", 2),
           TO.info(91, "write", 2)]
    hj += [JO.invoke(90, "write", 1), JO.invoke(91, "write", 2),
           JO.info(91, "write", 2)]
    ta, tp = TSH.atoms_of(t_pack(ht))
    ja, jp = JSH.atoms_of(j_pack(hj))
    assert [a.tolist() for a in ta] == [a.tolist() for a in ja]
    assert np.array_equal(tp, jp)
    assert any(len(a) == 1 for a in ta) and tp.any()


def test_subset_packed_columns_equal():
    ht = TS.register_history(random.Random(1), 3, 60, p_info=0.1)
    hj = JS.register_history(random.Random(1), 3, 60, p_info=0.1)
    pt, pj = t_pack(ht), j_pack(hj)
    atoms, pinned = TSH.atoms_of(pt)
    keep = pinned.copy()
    for a in atoms[::2]:
        keep[a] = True
    st, sj = t_subset(pt, keep), j_subset(pj, keep)
    for col in ("process", "type", "f", "value", "trans", "pair", "fails",
                "time"):
        assert np.array_equal(getattr(st, col), getattr(sj, col)), col
    for tab in ("process_table", "f_table", "value_table",
                "transition_table"):
        assert getattr(st, tab) == getattr(sj, tab), tab
    assert _maps(st.ops) == _maps(sj.ops)


@pytest.mark.parametrize("keep,match", [([True, False], "pair-closed"),
                                        ([True, True, True], "mask shape")])
def test_subset_packed_raises_as_the_reference(keep, match):
    pt = t_pack([TO.invoke(0, "write", 1), TO.ok(0, "write", 1)])
    pj = j_pack([JO.invoke(0, "write", 1), JO.ok(0, "write", 1)])
    with pytest.raises(ValueError, match=match) as et:
        t_subset(pt, np.array(keep))
    with pytest.raises(ValueError, match=match) as ej:
        j_subset(pj, np.array(keep))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("engine", ["keys", "stream"])
def test_pack_batch_masked_statuses_equal(engine):
    (ht, _), (hj, _) = _seed("stale-read", 80)
    jt = TSH.Shrinker(ht, "cas-register", F=F, device="cpu")
    jj = JSH.Shrinker(hj, "cas-register", F=F)
    rng = np.random.default_rng(3)
    sets = [jt.cur, [], jt.cur[: len(jt.cur) // 2], jt.cur[len(jt.cur) // 2:]]
    sets += [sorted(rng.choice(jt.cur, size=len(jt.cur) // 3,
                               replace=False).tolist()) for _ in range(4)]
    masks = [jt.mask_of(s) for s in sets]
    assert all(np.array_equal(m, jj.mask_of(s)) for m, s in zip(masks, sets))
    bt = TB.pack_batch_masked(jt.packed, masks, jt.memo)
    bj = JB.pack_batch_masked(jj.packed, masks, jj.memo)
    assert bt.P == bj.P and bt.kind.shape == bj.kind.shape == (len(masks), 0)
    assert all(np.array_equal(a, b) for a, b in zip(bt.remaps, bj.remaps))
    st, ft, _ = TB.check_batch(bt, F=F, engine=engine, device="cpu")
    sj, fj, _ = JB.check_batch(bj, F=F, engine="keys")
    assert st.tolist() == sj.tolist()
    assert ft.tolist() == fj.tolist()
    assert st[0] == 1 and st[1] == 0     # the seed INVALID, nothing VALID


def test_check_candidates_batches_as_the_reference():
    (ht, _), (hj, _) = _seed("stale-read", 40)
    jt = TSH.Shrinker(ht, "cas-register", F=F, device="cpu")
    jj = JSH.Shrinker(hj, "cas-register", F=F)
    sets = [jt.cur, [], jt.cur, jt.cur[:3]]
    ct, cj = {}, {}
    st = TSH.check_candidates(jt.packed, [jt.mask_of(s) for s in sets],
                              jt.memo, F=F, engine="keys", counters=ct,
                              device="cpu")
    sj = JSH.check_candidates(jj.packed, [jj.mask_of(s) for s in sets],
                              jj.memo, F=F, engine="keys", counters=cj)
    assert st.tolist() == sj.tolist() and ct == cj
    assert TSH.check_candidate(jt.packed, jt.mask_of(jt.cur), jt.memo, F=F,
                               engine="keys", device="cpu") == 1


# --- minimize on the linear axis ---------------------------------------------

@pytest.mark.parametrize("kind", TS.ANOMALY_KINDS)
def test_minimize_equal_and_recovers_the_truth(kind):
    (ht, truth), (hj, _) = _seed(kind, 600)
    rt = TSH.minimize(ht, checker="linear", model="cas-register", F=F,
                      engine="keys", device="cpu")
    rj = JSH.minimize(hj, checker="linear", model="cas-register", F=F,
                      engine="keys")
    assert _fields(rt) == _fields(rj)
    assert rt.one_minimal and rt.valid is False and not rt.partial
    assert sorted(map(_sig, rt.ops)) == sorted(map(_sig, truth))


def test_minimize_auto_recovers_the_truth_and_the_certificate():
    """``auto`` runs the kernel's plain version at 128 and escalates: the
    truth and the 1-minimality certificate, re-derived on the host."""
    from comdb2_tpu_torch.checker import analysis
    from comdb2_tpu_torch.models.model import cas_register

    (ht, truth), _ = _seed("lost-update", 300, seed=5)
    r = TSH.minimize(ht, F=1024, device="cpu")
    assert r.one_minimal and sorted(map(_sig, r.ops)) == \
        sorted(map(_sig, truth))
    p = t_pack([op.with_() for op in r.ops])
    atoms, pinned = TSH.atoms_of(p)
    for k in range(len(atoms)):
        keep = pinned.copy()
        for j, a in enumerate(atoms):
            if j != k:
                keep[a] = True
        assert analysis(cas_register(), t_subset(p, keep).ops,
                        backend="host", device="cpu").valid is not False


def test_check_candidates_mxu_equal_at_wide_p():
    """P >= 16: both packages' candidates through the MXU engine at the
    same F (two kept-op buckets, so two launches)."""
    def wide(O):
        h = [op for p in range(16) for op in (O.invoke(p, "write", p % 3),
                                             O.ok(p, "write", p % 3))]
        return h + [O.invoke(16, "read", None), O.ok(16, "read", 7)]

    jt = TSH.Shrinker(wide(TO), F=256, engine="mxu", device="cpu")
    jj = JSH.Shrinker(wide(JO), F=256, engine="mxu")
    sets = [jt.cur, jt.cur[:-1], jt.cur[1:], jt.cur[::2] + [jt.cur[-1]]]
    ct, cj = {}, {}
    st = TSH.check_candidates(jt.packed, [jt.mask_of(s) for s in sets],
                              jt.memo, F=256, engine="mxu", counters=ct,
                              device="cpu")
    sj = JSH.check_candidates(jj.packed, [jj.mask_of(s) for s in sets],
                              jj.memo, F=256, engine="mxu", counters=cj)
    assert st.tolist() == sj.tolist() == [1, 0, 1, 1]
    assert ct == cj == {"candidates": 4, "dispatches": 2}


def test_round_cap_equal_and_certified():
    (ht, truth), (hj, _) = _seed("lost-update", 30, seed=41)
    jobs = [TSH.Shrinker(ht, "cas-register", F=F, engine="keys", round_cap=2,
                         device="cpu"),
            JSH.Shrinker(hj, "cas-register", F=F, engine="keys",
                         round_cap=2)]
    for job in jobs:
        seen = 0
        while not job.step():
            assert job.counters["candidates"] - seen <= 2
            seen = job.counters["candidates"]
    rt, rj = (job.result() for job in jobs)
    assert _fields(rt) == _fields(rj)
    assert rt.one_minimal and sorted(map(_sig, rt.ops)) == \
        sorted(map(_sig, truth))


def test_valid_seed_raises_with_the_same_verdict():
    ht = TS.register_history(random.Random(9), 3, 24, p_info=0.0)
    hj = JS.register_history(random.Random(9), 3, 24, p_info=0.0)
    with pytest.raises(TSH.SeedVerdictError) as et:
        TSH.minimize(ht, F=F, engine="keys", device="cpu")
    with pytest.raises(JSH.SeedVerdictError) as ej:
        JSH.minimize(hj, F=F, engine="keys")
    assert et.value.verdict is ej.value.verdict is True
    assert str(et.value) == str(ej.value)


def test_unknown_seed_raises_with_the_same_verdict():
    def pend(O):
        return ([O.invoke(i, "write", i) for i in range(5)]
                + [O.ok(i, "write", i) for i in range(5)])

    with pytest.raises(TSH.SeedVerdictError) as et:
        TSH.minimize(pend(TO), F=2, engine="keys", device="cpu")
    with pytest.raises(JSH.SeedVerdictError) as ej:
        JSH.minimize(pend(JO), F=2, engine="keys")
    assert et.value.verdict == ej.value.verdict == "unknown"


def test_deadline_returns_partial_best_so_far():
    (ht, _), (hj, _) = _seed("stale-read", 200)
    rt = TSH.minimize(ht, F=F, engine="keys", deadline_s=0.0, device="cpu")
    rj = JSH.minimize(hj, F=F, engine="keys", deadline_s=0.0)
    assert _fields(rt) == _fields(rj)
    assert rt.partial and not rt.one_minimal and rt.rounds == 1


def test_max_rounds_returns_partial():
    (ht, _), (hj, _) = _seed("stale-read", 200)
    rt = TSH.minimize(ht, F=F, engine="keys", max_rounds=3, device="cpu")
    rj = JSH.minimize(hj, F=F, engine="keys", max_rounds=3)
    assert _fields(rt) == _fields(rj) and rt.partial and rt.rounds == 3


# --- the txn axis ------------------------------------------------------------

def _ring(O, k, dirty, dp=500, dk=500):
    """A write-skew rw ring of ``k`` txns and an audit read; with
    ``dirty`` its first txn fails but is observed (the ``-R`` shape)."""
    h = []
    for i in range(k):
        mops = (("r", dk + i, None), ("append", dk + (i + 1) % k, 1))
        done = (("r", dk + i, ()), ("append", dk + (i + 1) % k, 1))
        h.append(O.invoke(dp + i, "txn", mops))
        h.append(O.Op(dp + i, "fail" if dirty and i == 0 else "ok", "txn",
                      done))
    h.append(O.invoke(dp + k, "txn",
                      tuple(("r", dk + i, None) for i in range(k))))
    h.append(O.Op(dp + k, "ok", "txn",
                  tuple(("r", dk + i, (1,)) for i in range(k))))
    return h


def _shift(ops, dp=100, dk=100):
    return [op.with_(process=op.process + dp,
                     value=None if op.value is None else
                     tuple((f, k + dk, x) for f, k, x in op.value))
            for op in ops]


@pytest.mark.parametrize("dirty", [False, True], ids=["T", "R"])
@pytest.mark.parametrize("realtime", [False, True])
def test_txn_ring_over_a_base_equal(dirty, realtime):
    hs = [S.list_append_history(random.Random(11), n_procs=3, n_txns=400,
                                n_keys=4) + _ring(O, 8, dirty)
          for S, O in ((TS, TO), (JS, JO))]
    rt = TSH.minimize(hs[0], checker="txn", realtime=realtime,
                      device="cpu")
    rj = JSH.minimize(hs[1], checker="txn", realtime=realtime)
    assert _fields(rt) == _fields(rj)
    assert rt.one_minimal and rt.extra["anomaly_class"] == "G2-item"
    # realtime edges close a shorter cycle through the ring's neighbours
    assert len(rt.extra["txns"]) == (2 if realtime else 8)


@pytest.mark.parametrize("name", ["g1c.edn", "g2_item.edn"])
def test_txn_fixtures_equal(name):
    from comdb2_tpu.ops.history import parse_history as jparse
    from comdb2_tpu_torch.ops.history import parse_history as tparse

    text = (FIX / "txn" / name).read_text()
    rt = TSH.minimize(tparse(text), checker="txn", device="cpu")
    rj = JSH.minimize(jparse(text), checker="txn")
    assert _fields(rt) == _fields(rj) and rt.valid is False


@pytest.mark.parametrize("kind", ["g1a", "g2-item"])
def test_txn_anomaly_seeds_equal(kind):
    """``g1a``: a direct-anomaly seed, answered at once and not
    certified; ``g2-item``: a cycle on a clean base."""
    hs = []
    for S in (TS, JS):
        base = (S.list_append_history(random.Random(11), 3, 24, 3)
                if kind != "g1a" else [])
        hs.append(list(base) + _shift(S.txn_anomaly_history(kind)))
    rt = TSH.minimize(hs[0], checker="txn", device="cpu")
    rj = JSH.minimize(hs[1], checker="txn")
    assert _fields(rt) == _fields(rj)
    if kind == "g1a":
        assert not rt.one_minimal and rt.extra["anomalies"] == ["G1a"]
    else:
        assert rt.one_minimal and rt.extra.get("evidence_txns")


def test_txn_valid_seed_raises_with_the_same_verdict():
    ht = TS.list_append_history(random.Random(13), 3, 16, 3)
    hj = JS.list_append_history(random.Random(13), 3, 16, 3)
    with pytest.raises(TSH.SeedVerdictError) as et:
        TSH.minimize(ht, checker="txn", device="cpu")
    with pytest.raises(JSH.SeedVerdictError) as ej:
        JSH.minimize(hj, checker="txn")
    assert et.value.verdict is ej.value.verdict is True


def test_unknown_checker_raises():
    with pytest.raises(ValueError, match="no shrinker"):
        TSH.minimize([], checker="wgl", device="cpu")


# --- a device fault reaches the caller ---------------------------------------

def test_a_device_error_propagates_out_of_minimize(monkeypatch):
    """The JAX package turns any exception around ``check_batch`` into an
    UNKNOWN chunk; the port catches nothing there, so a device fault is
    never taken for a verdict."""
    from comdb2_tpu_torch.shrink import verdicts

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(verdicts, "check_batch", boom)
    (ht, _), _ = _seed("stale-read", 40)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TSH.minimize(ht, F=F, device="cpu")


def test_a_device_error_propagates_out_of_the_txn_axis(monkeypatch):
    from comdb2_tpu_torch.txn import closure_torch

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr(closure_torch, "closure_diag_batch", boom)
    h = TS.list_append_history(random.Random(11), 3, 24, 3) + \
        _shift(TS.txn_anomaly_history("g2-item"))
    with pytest.raises(RuntimeError, match="launch failure"):
        TSH.minimize(h, checker="txn", device="cpu")


def test_shrink_package_catches_nothing_around_the_device():
    """No ``try`` in ``comdb2_tpu_torch/shrink/`` has a handler for
    ``Exception``, ``BaseException`` or everything."""
    broad = []
    for path in (ROOT / "comdb2_tpu_torch" / "shrink").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler) and (
                    node.type is None or (isinstance(node.type, ast.Name)
                                          and node.type.id in
                                          ("Exception", "BaseException"))):
                broad.append((path.name, node.lineno))
    assert broad == []


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    (ht, _), _ = _seed("stale-read", 20)
    for make in (lambda: TSH.Shrinker(ht), lambda: TSH.minimize(ht),
                 lambda: TSH.TxnShrinker([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# --- filetest --shrink --store -----------------------------------------------

def _run_filetest(main, argv, store, capsys):
    rc = main(argv + ["--store", str(store)])
    err = capsys.readouterr().err
    files = {}
    if (store / "shrink").exists():
        runs = [d for d in os.listdir(store / "shrink") if d != "latest"]
        assert len(runs) == 1
        run = store / "shrink" / runs[0]
        assert os.readlink(store / "shrink" / "latest") == runs[0]
        files = {f: (run / f).read_bytes() for f in sorted(os.listdir(run))}
        err = err.replace(str(run), "RUN")
    return rc, err.splitlines(), files


@pytest.mark.parametrize("argv,rc", [
    (["shrink/stale_read.edn"], 1),
    (["txn/g2_item.edn", "--txn"], 1),
    (["txn/g1c.edn", "--txn"], 1),
    (["txn/g2_item.edn", "--txn", "--realtime"], 1),
    (["txn/clean.edn", "--txn"], 0),
    (["wl/sets_lost.edn", "--checker", "sets"], 1)])
def test_filetest_shrink_equal_to_the_reference(tmp_path, capsys, argv, rc):
    argv = [str(FIX / argv[0]), "--shrink"] + argv[1:]
    got = _run_filetest(filetest.main, argv + ["--device", "cpu"],
                        tmp_path / "port", capsys)
    want = _run_filetest(jax_filetest.main, argv, tmp_path / "jax", capsys)
    assert got == want
    assert got[0] == rc
    if got[2]:
        assert set(got[2]) == {"minimal.edn", "results.edn", "shrink.svg"}
        assert b'"one-minimal?" true' in got[2]["results.edn"]
        assert b'"reverified-valid?" false' in got[2]["results.edn"]
        # the minimal history re-checks INVALID on its own
        m = tmp_path / "minimal.edn"
        m.write_bytes(got[2]["minimal.edn"])
        assert filetest.main([str(m), "--device", "cpu"] + argv[2:]) == 1
        capsys.readouterr()


def test_filetest_shrink_of_a_valid_history_writes_nothing(tmp_path, capsys):
    h = TS.register_history(random.Random(37), 3, 20, p_info=0.0)
    p = tmp_path / "good.edn"
    p.write_text(history_to_edn(h))
    rc, err, files = _run_filetest(
        filetest.main, [str(p), "--shrink", "--device", "cpu"],
        tmp_path / "store", capsys)
    assert rc == 0 and files == {}
    assert "only INVALID histories shrink" in "\n".join(err)
    assert not (tmp_path / "store").exists()
