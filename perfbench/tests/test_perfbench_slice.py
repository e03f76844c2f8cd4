"""The device trace's slice: without ``trace_calls`` in the traffic file
the profiler covers the whole window, and its readers read what they
read before the slice existed; with it, the profiler covers that many
calls made after the window closed, from the call ``trace_start`` names,
and every reader of the device trace reads those calls alone while the
span readers read the window alone. ``whole_passes`` ends the window on
a whole pass over the pool."""

import json
import os

import pytest

from conftest import ROOT
from perfbench.lib import cells, devtrace, harness, roofline
from perfbench.lib.harness import Call, Context, Slice
from perfbench.lib.peaks import Peaks

W0 = 100.0
#: three calls in the window, a fourth in a slice after it, and a device
#: op inside each
CALLS = [(100.0, 102.0), (102.0, 105.0), (105.0, 110.0)]
AFTER = (111.0, 115.0)
OPS = [(100.5, 101.5, "seg_search"), (103.0, 104.0, None),
       (106.0, 108.0, None), (112.0, 113.0, "seg_search")]
PEAKS = Peaks(1e9, 1e9, 1, 1.0, 700.0)


def _ctx(after: bool) -> Context:
    """The window's three calls; the slice is the window, or the one
    call after it."""
    calls = [Call(i, a, b, ops=1000) for i, (a, b) in enumerate(CALLS)]
    if after:
        sl = Slice([Call(1, *AFTER, ops=1000)], *AFTER)
    else:
        sl = Slice(calls, W0, calls[-1].t1)
    tr = devtrace.Trace([devtrace.DeviceOp("seg_search_kernel_2_" if k
                                           else "copy", a, b, k)
                         for a, b, k in OPS if sl.t0 <= a and b <= sl.t1])
    spans = [("linear.device", a + 0.1, b - 0.1) for a, b in CALLS + [AFTER]]
    need = {"seg_search": (0.25e9 * len(sl.calls), 0)}
    return Context(None, calls, W0, calls[-1].t1, 0.0, spans, tr, None,
                   need, PEAKS, sl)


def _read(metric, ctx):
    return cells.load_module(ROOT, "metrics", metric).read(ctx)


def test_a_slice_of_every_call_reads_the_window():
    """The values the readers gave before the slice existed: the busy
    share of the window, the least time of the window's need over the
    window, the window's idle stretches."""
    ctx = _ctx(after=False)
    assert ctx.slice_s == ctx.window_s
    assert ctx.busy_s == pytest.approx(4.0)
    assert _read("device_idle_pct", ctx) == pytest.approx(
        100.0 * (1 - 4.0 / 10.0))
    assert _read("check_mfu", ctx) == pytest.approx(100.0 * 0.75 / 10.0)
    assert _read("seg_search_roofline.single", ctx) == pytest.approx(
        100.0 * 0.75 / 1.0)
    b = harness.breakdown(ctx)
    assert dict(b["device_ops"]) == pytest.approx(
        {"seg_search_kernel_2_": 1.0, "copy": 3.0})
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(6.0)


def test_a_slice_after_the_window_reads_its_call_alone():
    ctx = _ctx(after=True)
    assert ctx.slice_s == pytest.approx(4.0)
    assert _read("device_idle_pct", ctx) == pytest.approx(75.0)
    assert _read("check_mfu", ctx) == pytest.approx(100.0 * 0.25 / 4.0)
    assert _read("seg_search_roofline.single", ctx) == pytest.approx(
        100.0 * 0.25 / 1.0)
    b = harness.breakdown(ctx)
    assert dict(b["device_ops"]) == {"seg_search_kernel_2_":
                                     pytest.approx(1.0)}
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"linear.device": 2.8, "between calls": 0.2})


@pytest.mark.parametrize("after", [False, True])
def test_the_span_readers_read_the_window_alone(after):
    """``linear.device`` in the window's three calls, 1.8 + 2.8 + 4.8 s
    over 3 kops, whether or not a slice follows the window."""
    v = _read("escalation_ms_per_kop", _ctx(after))
    assert v == pytest.approx(9.4e3 / 3)


def test_the_marker_ties_the_trace_to_the_monotonic_clock():
    tr = devtrace._read([(5_000, 1_000, "void fill(int)"),
                         (2_000_005_000, 500_000_000,
                          "void seg_search_kernel_2_(int*)")], 50.0)
    assert [(o.name, o.t0, o.t1) for o in tr.ops] == [
        ("seg_search_kernel_2_", pytest.approx(52.0),
         pytest.approx(52.5))]


class _FakeProfiler:
    def __init__(self):
        self.starts = self.stops = 0

    def start(self):
        self.starts += 1

    def stop(self):
        self.stops += 1

    def read(self):
        return devtrace.Trace([devtrace.DeviceOp("seg_search_kernel_2_",
                                                 1.0, 2.0)])


@pytest.mark.parametrize("outside", [0, 1, 2])
def test_launch_kinds_are_those_noted_inside_the_slice(outside):
    """One kernel run in the trace, one launch noted while the profiler
    runs, and ``outside`` more before it starts or after it stops: those
    are not counted, so the run gets its kind."""
    from comdb2_tpu_torch.utils import compile_guard

    real = compile_guard.note_launch
    instr = harness._Instruments(cuda=False)
    instr.prof = _FakeProfiler()
    instr.start()
    if outside:
        compile_guard.note_launch("seg_search", "test")
    instr.profile()
    compile_guard.note_launch("seg_search", "test")
    instr.unprofile()
    if outside > 1:
        compile_guard.note_launch("seg_search", "test")
    _, tr = instr.stop()
    assert compile_guard.note_launch is real
    assert (instr.prof.starts, instr.prof.stops) == (1, 1)
    assert instr.launches == ["seg_search"]
    assert tr.ops[0].kind == "seg_search"


class _Pool:
    least_calls = 4

    def units(self, j):
        return [(j % 4,)]

    def mutated(self, u):
        return u[0] in (1, 3)


def test_the_slice_starts_where_the_traffic_file_says():
    assert harness.slice_start(_Pool(), "mutated") == 1
    assert harness.slice_start(_Pool(), 2) == 2


def _edit_traffic(root, cell, **keys):
    """Set (or, where None, drop) keys of ``cell``'s traffic file."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    w = {w["name"]: w for w in bench["workloads"]}[cell]
    path = os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json")
    with open(path) as fh:
        t = json.load(fh)
    for k, v in keys.items():
        t.pop(k, None)
        if v is not None:
            t[k] = v
    with open(path, "w") as fh:
        json.dump(t, fh)
    return bench


def _capture(root, cell, **keys):
    """``cell`` traced once on the CPU with ``keys`` in its traffic
    file, and a reader that keeps what it is given."""
    bench = _edit_traffic(root, cell, **keys)
    with open(os.path.join(root, "perfbench", "metrics", "kept.py"),
              "w") as fh:
        fh.write("SEEN = []\n\ndef read(ctx):\n    SEEN.append(ctx)\n")
    bench["per_layer"].append({"name": "kept", "unit": "ctx",
                               "better": "higher", "source": "host_clock",
                               "layer": "checker entry",
                               "moves": "check_ops_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    c = cells.load(root, cell)
    r = harness.run_cell(c, 2**31 + 77, 1.0, True, device="cpu")
    assert r["correct"], r["checks"]
    return c, r, cells.load_module(root, "metrics", "kept").SEEN[-1]


def _need(cell, calls):
    caller = cell.caller().Caller(cell, 2**31 + 77, "cpu")
    caller.make_pool()
    units = {u for c in calls for u in c.answers}
    return {"seg_search": roofline.need([caller.truth(u) for u in
                                         sorted(units)])}


def test_a_slice_of_one_call_needs_what_that_call_answered(small_root):
    cell, r, ctx = _capture(small_root, "register10p.indep", trace_calls=1,
                            trace_start="mutated")
    (c,) = ctx.slice.calls
    assert list(c.answers) == [(1,)]          # the pool's first mutated
    assert ctx.slice.t0 >= ctx.w1 and ctx.slice.t1 == c.t1
    assert ctx.need == _need(cell, [c])
    assert ctx.need != _need(cell, ctx.calls)
    assert r["attempted"] == len(ctx.calls) + 1
    assert r["device"]["trace_calls"] == 1
    assert r["device"]["window_s"] == pytest.approx(ctx.slice_s)


@pytest.mark.parametrize("cell", ["ctest5p.single", "register10p.indep"])
def test_without_trace_calls_the_slice_is_the_window(small_root, cell):
    cell, r, ctx = _capture(small_root, cell, trace_calls=None)
    assert ctx.slice.calls is ctx.calls
    assert len(ctx.calls) == r["attempted"]
    assert (ctx.slice.t0, ctx.slice.t1) == (ctx.w0, ctx.w1)
    assert ctx.need == _need(cell, ctx.calls)
    assert r["device"]["window_s"] == pytest.approx(ctx.window_s)


@pytest.mark.parametrize("seconds", [0.0, 1.5])
def test_whole_passes_end_the_window_on_a_pass(small_root, seconds):
    cell = "register10p.indep"
    _edit_traffic(small_root, cell, whole_passes=True)
    r = harness.run_cell(cells.load(small_root, cell), 2**31 + 78, seconds,
                         False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] % 4 == 0 and r["attempted"] >= 4
