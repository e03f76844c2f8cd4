"""The port's reports and store (``comdb2_tpu_torch.report``,
``harness.store``) and the checker objects' artifacts against the JAX
package's, byte for byte.

The SVG and EDN writers are deterministic string code: on the same
input both packages must write the same bytes. Store directory names
carry a timestamp, so the files are compared, not the paths. The one
field that is not a function of the input, an analysis' wall time
``time_s`` inside a per-key ``results.edn``, is compared by its key
only. Linearizability and serializability run on the host engines or
on CPU tensors (``device="cpu"``).
"""

import os
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from comdb2_tpu.checker import checkers as JC
from comdb2_tpu.checker import independent as JI
from comdb2_tpu.checker import linear as JL
from comdb2_tpu.harness import store as JST
from comdb2_tpu.models import model as JM
from comdb2_tpu.ops import op as JO
from comdb2_tpu.ops import synth as JS
from comdb2_tpu.ops.history import parse_history as jparse
from comdb2_tpu.report import linear_svg as JLS
from comdb2_tpu.report import shrink_svg as JSS
from comdb2_tpu.report import svg as JSVG
from comdb2_tpu.report import txn_svg as JTS
from comdb2_tpu.txn import check_txn as j_check_txn
from comdb2_tpu import shrink as JSH

from comdb2_tpu_torch.checker import checkers as TC
from comdb2_tpu_torch.checker import independent as TI
from comdb2_tpu_torch.checker import linear as TL
from comdb2_tpu_torch.harness import store as TST
from comdb2_tpu_torch.models import model as TM
from comdb2_tpu_torch.ops import op as TO
from comdb2_tpu_torch.ops import synth as TS
from comdb2_tpu_torch.ops.edn import read_edn
from comdb2_tpu_torch.ops.history import parse_history as tparse
from comdb2_tpu_torch.report import linear_svg as TLS
from comdb2_tpu_torch.report import shrink_svg as TSS
from comdb2_tpu_torch.report import svg as TSVG
from comdb2_tpu_torch.report import txn_svg as TTS
from comdb2_tpu_torch.txn import check_txn as t_check_txn
from comdb2_tpu_torch import shrink as TSH

FIX = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root: Path) -> dict:
    """Every file under ``root`` by its relative path, and every symlink
    by its target."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for name in dirs + files:
            p = Path(dirpath) / name
            rel = str(p.relative_to(root))
            if p.is_symlink():
                out[rel] = ("link", os.readlink(p))
            elif p.is_file():
                out[rel] = p.read_bytes()
    return out


def _invalid_register(S, seed, n_events=60, timed=False):
    """The first ``mutate`` of a seeded register history that the host
    engine finds INVALID, in package ``S``."""
    rng = random.Random(seed)
    base = S.register_history(rng, 3, n_events, values=3)
    if timed:
        base = [op.with_(time=1000 * i + (i % 7) ** 3)
                for i, op in enumerate(base)]
    for _ in range(64):
        h = S.mutate(rng, base, values=3)
        if S is TS:
            a = TL.analysis(TM.cas_register(), h, backend="host",
                            device="cpu")
        else:
            a = JL.analysis(JM.cas_register(), h, backend="host")
        if a.valid is False:
            return h
    raise AssertionError("no INVALID mutation")


# --- svg.py ------------------------------------------------------------------

def _drawing(svg_mod):
    s = svg_mod.SVG(400, 300)
    ax = svg_mod.Axes(s, (0, 1234.5), (0.001, 5e4), log_y=True)
    ax.frame(xlabel="t <s>", ylabel="latency & ms", title="a \"title\"")
    ax2 = svg_mod.Axes(s, (3, 3), (-2.5, 7.25))
    ax2.frame()
    s.line(0, 0, 10.123, 20.987, dash="4,3")
    s.rect(1, 2, 3, 4, fill="#abc", opacity=0.5, title="<op> & more")
    s.circle(5, 6, 2, title="x")
    s.text(7, 8, "héllo <&>", anchor="end")
    s.polyline([(0, 0), (1.005, 2.499)], title="p", opacity=0, cls="hit")
    s.style(".a{b:c}")
    s.open_group(**{"class": "g"})
    s.close_group()
    return s.render()


def test_svg_document_byte_equal():
    assert _drawing(TSVG) == _drawing(JSVG)


@pytest.mark.parametrize("v", [0, 0.001, 0.5, 1, 2.5, 999, 1000, -42,
                               12345.678, 1e-9, 7.0])
def test_fmt_equal(v):
    assert TSVG._fmt(v) == JSVG._fmt(v)


@pytest.mark.parametrize("lo,hi,n", [(0, 1, 8), (0, 1234.5, 6), (3, 3, 5),
                                     (-7.5, 2.25, 4), (0.001, 0.009, 8),
                                     (10, 1e6, 3)])
def test_nice_ticks_equal(lo, hi, n):
    assert TSVG._nice_ticks(lo, hi, n) == JSVG._nice_ticks(lo, hi, n)


# --- linear_svg, txn_svg -----------------------------------------------------

@pytest.mark.parametrize("seed,timed", [(0, False), (1, True), (2, False)])
def test_render_analysis_byte_equal(seed, timed, tmp_path):
    ht = _invalid_register(TS, seed, timed=timed)
    hj = _invalid_register(JS, seed, timed=timed)
    at = TL.analysis(TM.cas_register(), ht, backend="host", device="cpu")
    aj = JL.analysis(JM.cas_register(), hj, backend="host")
    assert at.op_index == aj.op_index
    got = TLS.render_analysis(ht, at, str(tmp_path / "t" / "linear.svg"))
    want = JLS.render_analysis(hj, aj, str(tmp_path / "j" / "linear.svg"))
    assert got == want and "frontier died here" in got
    assert (tmp_path / "t" / "linear.svg").read_bytes() == \
        (tmp_path / "j" / "linear.svg").read_bytes()


def test_render_analysis_without_paths_byte_equal():
    """An analysis-like object with only ``op_index`` and ``configs``."""
    class A:
        op_index = 3
        configs = [{"model": "r 1", "pending": []}]

    ht = TS.register_history(random.Random(4), 3, 20)
    hj = JS.register_history(random.Random(4), 3, 20)
    assert TLS.render_analysis(ht, A()) == JLS.render_analysis(hj, A())


@pytest.mark.parametrize("name,realtime", [("g1c.edn", False),
                                           ("g2_item.edn", False),
                                           ("g2_item.edn", True)])
def test_render_cycle_byte_equal(name, realtime):
    text = (FIX / "txn" / name).read_text()
    ct = t_check_txn(tparse(text), backend="host",
                     realtime=realtime)["counterexample"]
    cj = j_check_txn(jparse(text), backend="host",
                     realtime=realtime)["counterexample"]
    assert TTS.render_cycle(ct) == JTS.render_cycle(cj)


# --- shrink_svg --------------------------------------------------------------

def test_render_minimal_and_results_map_equal_on_the_linear_axis():
    hs = []
    for S in (TS, JS):
        base = S.register_history(random.Random(31), 3, 40, fs=("write",),
                                  p_info=0.0)
        hs.append(S.inject_anomaly(base, "stale-read")[0])
    rt = TSH.minimize(hs[0], F=64, engine="keys", device="cpu")
    rj = JSH.minimize(hs[1], F=64, engine="keys")
    vt, st = TSS.render_minimal(rt.ops)
    vj, sj = JSS.render_minimal(rj.ops)
    assert vt is vj is False and st == sj and st is not None
    assert TSS.results_map(rt, reverified=vt) == \
        JSS.results_map(rj, reverified=vj)
    assert TSS.results_map(rt) == JSS.results_map(rj)


@pytest.mark.parametrize("name", ["g1c.edn", "g2_item.edn", "clean.edn"])
def test_render_minimal_on_the_txn_axis_equal(name):
    text = (FIX / "txn" / name).read_text()
    assert TSS.render_minimal(tparse(text), checker="txn") == \
        JSS.render_minimal(jparse(text), checker="txn")


# --- the store ---------------------------------------------------------------

@pytest.mark.parametrize("test,opts", [
    ({}, None), ({"dir": "d"}, None), ({}, {"dir": "o"}),
    ({"dir": "d"}, {"dir": "o"}), ({"name": "n"}, None),
    ({"name": "n", "start-time": "t", "store-root": "r"}, None),
    (None, None)])
def test_artifact_dir_and_paths_equal(test, opts):
    assert TST.artifact_dir(test, opts) == JST.artifact_dir(test, opts)
    t = test or {}
    assert TST.path(t, "a", "b") == JST.path(t, "a", "b")


def test_save_shrink_and_symlinks_equal(tmp_path, monkeypatch):
    """Same files, the same ``latest`` links, under a frozen clock."""
    import time

    monkeypatch.setattr(time, "strftime", lambda fmt: "20261017T000000")
    monkeypatch.setattr(time, "time_ns", lambda: 123_456_789)
    results = {"valid?": False, "checker": "linear", "txns": (1, 2),
               "s": {3}, "np": np.int32(5),
               "obj": object.__name__}
    for mod, sub in ((TST, "t"), (JST, "j")):
        d = mod.save_shrink("[{:f :write}]\n", results, svg="<svg/>",
                            store_root=str(tmp_path / sub))
        assert d == os.path.join(str(tmp_path / sub), "shrink",
                                 "20261017T000000-456789")
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert (tmp_path / "t" / "latest").is_symlink()


def test_save_and_load_a_run_equal(tmp_path, monkeypatch):
    ht = _invalid_register(TS, 0)
    hj = _invalid_register(JS, 0)
    for mod, sub, h in ((TST, "t", ht), (JST, "j", hj)):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        test = {"name": "reg", "start-time": "20261017", "nodes": ("n1",),
                "store-root": "store", "history": h,
                "results": {"valid?": False, "op": h[3]}, "client": object()}
        mod.save_1(test)
        mod.save_2(test)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    stores = (str(tmp_path / "t" / "store"), str(tmp_path / "j" / "store"))
    lt = TST.load("reg", "20261017", stores[0])
    lj = JST.load("reg", "20261017", stores[1])
    assert [op.to_map() for op in lt.pop("history")] == \
        [op.to_map() for op in lj.pop("history")]
    # test.edn's own store-root wins over the one asked for, in both
    assert lt.pop("store-root") == lj.pop("store-root") == "store"
    assert lt == lj
    assert TST.tests("reg", stores[0]) == ["20261017"]
    assert TST.latest("reg", stores[0])["results"] == lt["results"]
    assert TST.latest("nope", stores[0]) is None


# --- the checker objects' artifacts ------------------------------------------

def test_linearizable_writes_linear_svg_byte_equal(tmp_path):
    ht = _invalid_register(TS, 2)
    hj = _invalid_register(JS, 2)
    rt = TC.Linearizable(device="cpu").check(
        {"dir": str(tmp_path / "t")}, TM.cas_register(), ht)
    rj = JC.Linearizable().check(
        {"dir": str(tmp_path / "j")}, JM.cas_register(), hj)
    assert rt["valid?"] is rj["valid?"] is False
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert set(_tree(tmp_path / "t")) == {"linear.svg"}
    # a VALID history and a test with no store directory write nothing
    good = TS.register_history(random.Random(3), 3, 30)
    TC.Linearizable(device="cpu").check({"dir": str(tmp_path / "v")},
                                        TM.cas_register(), good)
    TC.Linearizable(device="cpu").check({}, TM.cas_register(), ht)
    assert not (tmp_path / "v").exists()


@pytest.mark.parametrize("kind", ["g1c", "g2-item", "g1a"])
def test_serializable_writes_txt_and_svg_byte_equal(tmp_path, kind):
    rt = TC.Serializable(device="cpu").check(
        {}, None, TS.txn_anomaly_history(kind), {"dir": str(tmp_path / "t")})
    rj = JC.Serializable().check(
        {}, None, JS.txn_anomaly_history(kind), {"dir": str(tmp_path / "j")})
    assert rt["valid?"] is rj["valid?"] is False
    files = _tree(tmp_path / "t")
    assert files == _tree(tmp_path / "j")
    want = {"serializable.txt"} | (set() if kind == "g1a"
                                   else {"serializable.svg"})
    assert set(files) == want


def _keyed(O, key, bad=(1, 3)):
    """Four keys, each a 3-process register history of its own; the keys
    in ``bad`` end with a read of a value nothing wrote."""
    per = []
    for k in range(4):
        h = JS.register_history(random.Random(70 + k), n_procs=3,
                                n_events=30, values=3, p_info=0.0)
        if k in bad:
            h = h + [JO.invoke(3, "read", None), JO.ok(3, "read", 9)]
        per.append([O.Op(op.process + 10 * k, op.type, op.f,
                         key(k, op.value)) for op in h])
    out = []
    for i in range(max(map(len, per))):
        out += [h[i] for h in per if i < len(h)]
    return out


def _no_time(tree):
    return {k: re.sub(rb'"time_s" [0-9.e-]+', b'"time_s" T', v)
            if isinstance(v, bytes) else v for k, v in tree.items()}


@pytest.mark.parametrize("base", ["device", "host"])
def test_independent_checker_writes_per_key_files_equal(tmp_path, base):
    ht, hj = _keyed(TO, TI.tuple_), _keyed(JO, JI.tuple_)
    kw = {} if base == "device" else {"backend": "host"}
    rt = TI.IndependentChecker(TC.Linearizable(device="cpu", **kw)).check(
        {"dir": str(tmp_path / "t")}, TM.cas_register(), ht)
    rj = JI.IndependentChecker(JC.Linearizable(**kw)).check(
        {"dir": str(tmp_path / "j")}, JM.cas_register(), hj)
    assert rt["failures"] == rj["failures"] == [1, 3]
    files = _tree(tmp_path / "t")
    assert _no_time(files) == _no_time(_tree(tmp_path / "j"))
    for k in range(4):
        d = f"independent/{k}"
        assert {f"{d}/results.edn", f"{d}/history.edn"} <= set(files)
        assert (f"{d}/linear.svg" in files) == (k in rt["failures"])
        back = read_edn(files[f"{d}/results.edn"].decode())
        assert back["valid?"] == rt["results"][k]["valid?"]
