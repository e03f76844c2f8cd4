"""The port's span tracing (``obs/trace.py``) and ``filetest --trace``
against the JAX package's.

- The same sequence of spans (nesting, request ids, retroactive
  records, a bounded buffer that drops) through both modules exports
  the same Chrome trace-event document, timestamps aside: names,
  phases, parents, ``rid`` and other args, and the dropped count.
- ``filetest --trace PATH`` writes a trace with the parse, pack,
  device and finalize spans, exits with the same code as without
  ``--trace``, and leaves tracing off.
"""

import json
import random
from pathlib import Path

import pytest

from comdb2_tpu.obs import trace as jtrace

from comdb2_tpu_torch import filetest
from comdb2_tpu_torch.obs import trace
from comdb2_tpu_torch.ops.history import history_to_edn
from comdb2_tpu_torch.ops.synth import mutate, register_history


@pytest.fixture()
def tracing():
    """Both modules enabled and empty; both off and empty afterwards."""
    for t in (trace, jtrace):
        t.clear()
        t.enable()
    yield
    for t in (trace, jtrace):
        t.enable()             # the default cap
        t.disable()
        t.clear()


def _drive(t, max_spans=None):
    """One sequence of spans through trace module ``t``."""
    if max_spans is not None:
        t.enable(max_spans=max_spans)
    with t.request(41):
        with t.span("outer", k=1) as s:
            with t.span("inner"):
                pass
            s.set(bytes_h2d=64)
        with t.span("sibling", rid=7):
            pass

    @t.traced("decorated")
    def f(x):
        with t.span("in_decorated", n=x):
            return x + 1

    assert f(1) == 2
    t.record("retro", 1.0, 2.0, rid=9, bytes_d2h=128)
    for i in range(6):
        with t.span(f"tail{i}"):
            pass


def _shape(doc):
    """A trace document without its timestamps and process id."""
    ev = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                    "cat")}
          for e in doc["traceEvents"]]
    return ev, doc["otherData"], doc["displayTimeUnit"]


@pytest.mark.parametrize("max_spans", [None, 4])
def test_export_chrome_matches_the_reference(tracing, max_spans):
    _drive(trace, max_spans)
    _drive(jtrace, max_spans)
    got, want = trace.export_chrome(), jtrace.export_chrome()
    assert _shape(got) == _shape(want)
    assert trace.dropped_spans() == jtrace.dropped_spans()
    assert {e["cat"] for e in got["traceEvents"]} == {"comdb2_tpu_torch"}
    assert all(e["ph"] == "X" for e in got["traceEvents"])
    json.dumps(got)


def test_spans_nest_and_carry_the_request_id(tracing):
    _drive(trace)
    ev = {e["name"]: e for e in trace.export_chrome()["traceEvents"]}
    assert ev["inner"]["args"] == {"rid": 41, "parent": "outer"}
    assert ev["outer"]["args"] == {"k": 1, "bytes_h2d": 64, "rid": 41}
    assert ev["sibling"]["args"]["rid"] == 7
    assert ev["in_decorated"]["args"] == {"n": 1, "parent": "decorated"}
    assert ev["retro"]["dur"] == pytest.approx(1e6)
    o, i = ev["outer"], ev["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_bounded_buffer_counts_what_it_drops(tracing):
    trace.enable(max_spans=8)
    for i in range(20):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == [f"s{i}" for i in
                                               range(12, 20)]
    assert trace.dropped_spans() == 12
    assert trace.export_chrome()["otherData"]["dropped_spans"] == 12
    trace.clear()
    assert trace.spans() == [] and trace.dropped_spans() == 0


def test_disabled_mode_is_a_noop():
    trace.disable()
    trace.clear()
    assert trace.span("a") is trace.span("b", k=1)
    with trace.span("a") as s:
        assert s.set(x=1) is s
    trace.record("r", 0.0, 1.0)
    assert trace.spans() == [] and not trace.enabled()


def test_export_writes_the_file_atomically(tracing, tmp_path):
    _drive(trace)
    out = tmp_path / "t.json"
    doc = trace.export_chrome(str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert not (tmp_path / "t.json.tmp").exists()


def _register_edn(tmp_path, invalid):
    h = register_history(random.Random(6), n_procs=4, n_events=400,
                         values=5, p_info=0.0)
    if invalid:
        for seed in range(64):
            m = mutate(random.Random(seed), h, values=5)
            if m != h:
                h = m
                break
    path = tmp_path / "h.edn"
    path.write_text(history_to_edn(h))
    return path


FIXTURES = Path(__file__).resolve().parent / "fixtures"
RUNS = [
    ("linear-valid", None, ["--backend", "device"]),
    ("linear-mutated", None, ["--backend", "device"]),
    ("txn", f"{FIXTURES}/txn/g2_item.edn", ["--txn"]),
    ("txn", f"{FIXTURES}/txn/clean.edn", ["--txn"]),
    ("bank", f"{FIXTURES}/wl/bank_wrong_total.edn",
     ["--checker", "bank", "--wl-n", "8", "--wl-total", "160"]),
    ("sets", f"{FIXTURES}/wl/sets_valid.edn", ["--checker", "sets"]),
]


@pytest.mark.parametrize("run", RUNS, ids=[f"{r[0]}-{i}" for i, r in
                                           enumerate(RUNS)])
def test_filetest_trace_writes_the_stage_spans(tmp_path, run):
    kind, path, extra = run
    if path is None:
        path = _register_edn(tmp_path, invalid=kind == "linear-mutated")
    args = [str(path), "--device", "cpu", *extra]
    out = tmp_path / "trace.json"
    rc_plain = filetest.main(args)
    rc = filetest.main(args + ["--trace", str(out)])
    assert rc == rc_plain
    assert not trace.enabled() and trace.spans() == []
    doc = json.loads(out.read_text())
    ev = doc["traceEvents"]
    names = [e["name"] for e in ev]
    assert names[0] == "filetest.parse" and names[-1] == "filetest.finalize"
    parse = ev[0]["args"]
    assert parse["parser"] in ("native", "python")
    assert parse["ops"] > 0
    if kind.startswith("linear"):
        assert {"linear.analysis", "linear.pack", "linear.device",
                "linear.segments", "linear.kernel",
                "linear.decode"} <= set(names)
        parents = {e["name"]: e["args"].get("parent") for e in ev}
        assert parents["linear.kernel"] == "linear.device"
        assert parents["linear.device"] == "linear.analysis"
    elif kind == "txn":
        assert "txn.check" in names
    assert doc["otherData"]["dropped_spans"] == 0
