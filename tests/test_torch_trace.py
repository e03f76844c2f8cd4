"""The port's span tracing (``obs/trace.py``) and ``filetest --trace``
against the JAX package's.

- The same sequence of spans (nesting, request ids, retroactive
  records, a bounded buffer that drops) through both modules exports
  the same Chrome trace-event document, timestamps aside: names,
  phases, parents, ``rid`` and other args, and the dropped count.
- ``filetest --trace PATH`` writes a trace with the parse, pack,
  device and finalize spans, exits with the same code as without
  ``--trace``, and leaves tracing off.
- The store's web browser (``harness/web.py``): the index (with the
  daemon's ``timeline.svg`` and ``trace.json`` links), listings, path
  resolution, zip archives and the HTTP answers equal the JAX
  package's on the same store; the daemon's artifact pass writes
  ``timeline.svg`` byte-equal to the JAX package's renderer on the
  same records.
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


# --- the store's web browser (harness/web.py) -------------------------------

def _store(root: Path):
    """A results store with valid, invalid, unknown and unreadable runs,
    a ``latest`` link, and the verifier daemon's service artifacts."""
    runs = [("register", "20260101T000000.000", "{:valid? true}"),
            ("register", "20260102T000000.000",
             "{:valid? false, :op-index 7}"),
            ("bank", "20260103T000000.000", "{:valid? :unknown}"),
            ("bank", "20260104T000000.000", "{:valid? tru"),
            ("a <b>&c", "20260105T000000.000", "{:valid? true}")]
    for name, t, results in runs:
        d = root / name / t
        d.mkdir(parents=True)
        (d / "results.edn").write_text(results + "\n")
        (d / "history.edn").write_text("{:type :invoke}\n")
        (d / "sub").mkdir()
        (d / "sub" / "linear.svg").write_text("<svg/>")
    (root / "register" / "20260106T000000.000").mkdir()   # no results
    (root / "register" / "latest").symlink_to("20260102T000000.000")
    (root / "latest").symlink_to("register/20260102T000000.000")
    svc = root / "service"
    svc.mkdir()
    (svc / "latest.json").write_text(json.dumps(
        {"completed": 12, "dispatches": 3, "queue_depth": 1}))
    (svc / "timeline.svg").write_text("<svg/>")
    (svc / "trace.json").write_text("{}")
    return runs


def test_web_index_and_listings_equal_the_references(tmp_path):
    from comdb2_tpu.harness import web as jweb
    from comdb2_tpu_torch.harness import web

    runs = _store(tmp_path)
    root = str(tmp_path)
    assert web._runs(root) == jweb._runs(root)
    idx = web._index_html(root)
    assert idx == jweb._index_html(root)
    assert "timeline.svg" in idx and "trace.json" in idx
    assert "12 checked, 3 dispatches, queue 1" in idx
    for name, t, _ in runs:
        rel = f"{name}/{t}"
        assert web._listing_html(root, rel) == jweb._listing_html(root, rel)
    assert web._runs(str(tmp_path / "missing")) == []
    assert web.CONTENT_TYPES == jweb.CONTENT_TYPES


@pytest.mark.parametrize("rel", [
    "register/", "/register/20260101T000000.000", "../etc/passwd",
    "register/../../x", "%2e%2e/secret", "", "service/timeline.svg",
    "a%20%3Cb%3E%26c/", "register/latest/sub"])
def test_web_safe_rel_equal(tmp_path, rel):
    from comdb2_tpu.harness import web as jweb
    from comdb2_tpu_torch.harness import web

    _store(tmp_path)
    assert web._safe_rel(str(tmp_path), rel) == \
        jweb._safe_rel(str(tmp_path), rel)


def test_web_zip_of_a_run_holds_the_same_files(tmp_path):
    import io
    import zipfile

    from comdb2_tpu.harness import web as jweb
    from comdb2_tpu_torch.harness import web

    _store(tmp_path)
    rel = "register/20260101T000000.000"

    def files(data):
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            return {n: z.read(n) for n in z.namelist()}

    got = files(web._zip_run(str(tmp_path), rel))
    assert got == files(jweb._zip_run(str(tmp_path), rel))
    assert set(got) == {"results.edn", "history.edn", "sub/linear.svg"}


def _fetch(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def test_web_server_answers_as_the_references(tmp_path):
    """Both packages' servers on ports from the OS, over HTTP: status,
    content type and body equal for pages, files, 403 and 404 (the zip
    archives by their file names)."""
    import io
    import zipfile

    from comdb2_tpu.harness import web as jweb
    from comdb2_tpu_torch.harness import web

    _store(tmp_path)
    servers = [mod.serve(str(tmp_path), port=0, block=False)
               for mod in (web, jweb)]
    try:
        for path in ("/", "/index.html", "/files/register/",
                     "/files/service/timeline.svg",
                     "/files/register/20260101T000000.000/results.edn",
                     "/files/bank/20260104T000000.000/sub/linear.svg",
                     "/files/../../etc/passwd", "/files/nope",
                     "/zip/nope/x", "/other"):
            got, want = (_fetch(port, path) for _, port in servers)
            assert got == want, path
        got, want = (_fetch(port, "/zip/register/20260101T000000.000")
                     for _, port in servers)
        assert got[:2] == want[:2] == (200, "application/zip")
        names = [sorted(zipfile.ZipFile(io.BytesIO(r[2])).namelist())
                 for r in (got, want)]
        assert names[0] == names[1]
    finally:
        for srv, _ in servers:
            srv.shutdown()
            srv.server_close()


# --- the daemon's timeline.svg (service/daemon.py) ---------------------------

def test_daemon_writes_timeline_svg_byte_equal(tmp_path):
    """The port's daemon writes ``<store>/service/timeline.svg`` (where
    it wrote ``timeline.json`` before), byte-equal to the JAX package's
    renderer on the same records, and the port's web index links it."""
    from comdb2_tpu.harness import web as jweb
    from comdb2_tpu.report.service_svg import render_service_timeline
    from comdb2_tpu_torch.harness import web
    from comdb2_tpu_torch.service import VerifierCore
    from comdb2_tpu_torch.service.daemon import VerifierDaemon

    core = VerifierCore(device="cpu")
    rng = random.Random(4)
    now = 100.0
    for i in range(6):
        h = register_history(rng, 3, 24, p_info=0.0)
        if i % 2:
            h = mutate(rng, h)
        core.submit({"op": "check", "id": f"r{i}",
                     "history": history_to_edn(list(h))}, now)
        now += 0.25
        core.pump(now, idle=True)
    for _ in range(50):
        core.pump(now, idle=True)
        if len(core.timeline_records()[0]) == 6:
            break
        now += 0.01
    records, events = core.timeline_records()
    assert len(records) == 6
    store = tmp_path / "store"
    d = VerifierDaemon(core, store_root=str(store))
    try:
        d._save_artifact()
    finally:
        d._sel.close()
        d._lsock.close()
    svc = store / "service"
    assert (svc / "timeline.svg").read_text() == \
        render_service_timeline(records, events)
    assert not (svc / "timeline.json").exists()
    idx = web._index_html(str(store))
    assert idx == jweb._index_html(str(store))
    assert "timeline.svg" in idx
