"""The port's static invariant checker (``comdb2_tpu_torch.analysis``)
against its own tree and against the JAX package's checker.

Contracts:

- ``python -m comdb2_tpu_torch.analysis`` exits 0 on the port's tree;
  the raw scan (suppressions off) finds exactly the findings decided as
  by design, each carrying its marker;
- fixture parity: every JAX-package fixture that names no jax (and the
  two whose rules are ported as written) gives the same ``(rule,
  line)`` set through both packages' ``run_paths``;
- each torch twin under ``tests/fixtures/analysis_torch/`` trips
  exactly its rule at its marked lines;
- suppressions, the stale-suppression audit, the CLI's exit codes and
  artifacts, and ``--changed`` agreeing with a full run;
- the Hopper budget: every production tier accepted, known-bad specs
  rejected, ``smem_bytes`` equal to a hand count of
  ``kernels/seg_search.cu``'s formula, the constant mirror clean.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from comdb2_tpu import analysis as JA

from comdb2_tpu_torch import analysis as TA
from comdb2_tpu_torch.analysis import (dataflow, kernel_budget, lifecycle,
                                       lint)
from comdb2_tpu_torch.checker import seg_kernel as SK

REPO = TA.repo_root()
JFIX = os.path.join(REPO, "tests", "fixtures", "analysis")
TFIX = os.path.join(REPO, "tests", "fixtures", "analysis_torch")

#: the JAX package's fixtures that name no jax: both packages' checkers
#: must report the same (rule, line) set on each
JAX_FREE_FIXTURES = (
    "bad_keyed_history", "bad_kill_no_wait", "bad_leaked_pin",
    "bad_log_before_success", "bad_multiprocessing",
    "bad_mxu_unbucketed_dispatch", "bad_nemesis_completion",
    "bad_pack_per_op_loop", "bad_raw_clock_dispatch",
    "bad_ready_before_publish", "bad_shrink_dispatch_loop",
    "bad_stale_suppression", "bad_stale_ttl_timestamp",
    "bad_stream_megabatch_delta", "bad_sync_readback_pump",
    "bad_wl_unbucketed_dispatch", "bad_close_before_deregister")

#: JAX-bound fixtures whose rules the port keeps as written
AS_WRITTEN_FIXTURES = ("bad_env_jax", "bad_dup_cond")


def _run_cli(*argv, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "comdb2_tpu_torch.analysis", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


def _pairs(findings):
    return sorted({(f.rule, f.line) for f in findings})


@pytest.fixture(scope="module")
def repo_cli():
    """One full CLI run over the port's tree, shared by the tests that
    read it."""
    return _run_cli()


# --- the port's tree ---------------------------------------------------------

def test_repo_scan_is_clean(repo_cli):
    assert repo_cli.returncode == 0, repo_cli.stdout + repo_cli.stderr
    assert "OK: 0 findings" in repo_cli.stdout


def test_cli_reports_per_pass_timing(repo_cli):
    for name in ("lint", "kernel-budget", "bucket-audit",
                 "compile-surface", "lifecycle", "dataflow",
                 "suppression-audit"):
        assert re.search(rf"pass {name}: 0 finding\(s\) in [0-9.]+s",
                         repo_cli.stderr), repo_cli.stderr


def test_markers_are_exactly_the_decided_findings(repo_cli):
    """The port's tree carries exactly the markers of the findings
    decided as by design (each with its reason above it, and recorded
    in ROADMAP.md's Queue 3). With the repo scan clean and its
    stale-suppression audit silent, every marker is live and every
    other raw finding absent: this list IS the raw scan."""
    assert repo_cli.returncode == 0
    got = []
    for p in TA.collect_files():
        for line, rules in TA._markers(open(p).read()):
            got += [(r, os.path.relpath(p, REPO)) for r in rules or ("*",)]
    assert sorted(got) == [
        ("hopper-k-cap", "comdb2_tpu_torch/analysis/kernel_budget.py"),
        ("hopper-p-cap", "comdb2_tpu_torch/analysis/kernel_budget.py"),
        ("per-item-dispatch",
         "comdb2_tpu_torch/checker/linear_torch.py"),
        ("unbucketed-dispatch-site",
         "comdb2_tpu_torch/checker/batch.py"),
        ("wait-after-kill", "scripts/torch_elastic.py"),
    ], got


def test_scan_covers_the_port_only():
    files = [os.path.relpath(p, REPO) for p in TA.collect_files()]
    assert files and not any("fixtures" in f for f in files)
    assert "comdb2_tpu_torch/analysis/lint.py" in files
    assert "scripts/torch_fuzz_seg.py" in files
    assert "tests/test_torch_analysis.py" in files
    assert "tests/torch_cluster_parity.py" in files
    assert not any(f.startswith("comdb2_tpu/") for f in files)
    assert "scripts/fuzz_pallas_seg.py" not in files
    assert "tests/test_analysis.py" not in files


def test_ring_beat_never_blocks():
    """The serving ring's beat: ``pump`` / ``tick`` reach
    ``_ring_push`` / ``_ring_pop`` / ``_ring_drain`` through the direct
    call graph, and nothing the beat reaches in ``service/`` or
    ``stream/`` reads back or waits on the card (the readbacks live in
    the deferred finalize closures the ring pops)."""
    from comdb2_tpu_torch.analysis.compile_surface import (_file_infos,
                                                           _Graph)

    plane = [p for p in TA.collect_files()
             if "/service/" in p or "/stream/" in p]
    graph = _Graph(_file_infos(plane))
    reach = dataflow._hot_reach(graph)
    core = next(i for i in graph.infos
                if i.path.endswith("service/core.py"))
    reached = {core.funcs[n].name for n in
               ("_ring_push", "_ring_pop", "_ring_drain", "_launch")
               if id(core.funcs[n]) in reach}
    assert reached == {"_ring_push", "_ring_pop", "_ring_drain",
                       "_launch"}
    assert dataflow.scan_files(plane, apply_suppressions=False) == []


# --- fixture parity with the JAX package -------------------------------------

@pytest.mark.parametrize("name", JAX_FREE_FIXTURES + AS_WRITTEN_FIXTURES)
def test_fixture_parity_with_the_jax_package(name):
    path = os.path.join(JFIX, name + ".py")
    want = _pairs(JA.run_paths([path]))
    assert want, f"{name} trips nothing in the JAX package"
    assert _pairs(TA.run_paths([path])) == want


# --- torch twins -------------------------------------------------------------

def _marked(path):
    """``(rule, line)`` of every ``# <- rule-id`` marker."""
    out = set()
    for i, line in enumerate(open(path).read().splitlines(), 1):
        m = re.search(r"# <- ([a-z0-9-]+)", line)
        if m:
            out.add((m.group(1), i))
    return sorted(out)


TWINS = sorted(f for f in os.listdir(TFIX) if f.endswith(".py"))


def test_twin_inventory_matches_readme():
    readme = open(os.path.join(TFIX, "README.md")).read()
    listed = re.findall(r"^\| (bad_\w+\.py) \| ([a-z0-9-]+) \|", readme,
                        re.M)
    assert sorted(f for f, _ in listed) == TWINS
    for f, rule in listed:
        assert {r for r, _ in _marked(os.path.join(TFIX, f))} == {rule}


@pytest.mark.parametrize("fixture", TWINS)
def test_twin_trips_exactly_its_rule(fixture):
    path = os.path.join(TFIX, fixture)
    want = _marked(path)
    assert want, f"{fixture} marks no line"
    assert _pairs(TA.run_paths([path])) == want


@pytest.mark.parametrize("fixture", ["bad_spec_k9.py",
                                     "bad_per_item_transfer.py"])
def test_cli_fails_on_a_twin_with_an_anchor(fixture):
    r = _run_cli(os.path.join(TFIX, fixture))
    assert r.returncode == 1
    rule = _marked(os.path.join(TFIX, fixture))[0][0]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith(rule + " "))
    loc = line.split(" ", 2)[1]
    fpath, _, lineno = loc.rpartition(":")
    assert fpath.endswith(fixture) and int(lineno) > 0


# --- suppression -------------------------------------------------------------

def test_per_line_suppression():
    src = ("import torch\n"
           "x = sorted([1], key=hash)"
           "  # analysis: ignore[hash-dedup]\n")
    assert lint.lint_file("<mem>", src) == []
    wrong = src.replace("[hash-dedup]", "[per-item-dispatch]")
    assert [f.rule for f in lint.lint_file("<mem>", wrong)] == \
        ["hash-dedup"]
    blanket = src.replace("[hash-dedup]", "")
    assert lint.lint_file("<mem>", blanket) == []


def test_suppression_live_and_stale(tmp_path):
    """A live marker suppresses without being stale (dataflow's
    whole-set re-scan); a marker on a clean line is a stale-suppression
    finding (lifecycle's per-file re-scan); marker text in a string is
    not a marker; a blanket marker on a clean line is stale."""
    live = tmp_path / "pump_dispatch.py"
    live.write_text(
        "def pump(core):\n"
        "    x = core.buf.cuda()\n"
        "    return x.item()"
        "  # analysis: ignore[sync-readback-in-pump]\n")
    assert TA.run_paths([str(live)]) == []
    assert TA.audit_suppressions([str(live)]) == []
    stale = tmp_path / "svc_dispatch.py"
    stale.write_text(
        "def retire(proc):\n"
        "    proc.terminate()\n"
        "    proc.wait()  # analysis: ignore[wait-after-kill]\n")
    assert [f.rule for f in TA.run_paths([str(stale)])] == \
        ["stale-suppression"]
    prose = tmp_path / "prose.py"
    prose.write_text(
        'DOC = "append # analysis: ignore[hash-dedup] to the line"\n')
    assert TA.audit_suppressions([str(prose)]) == []
    blanket = tmp_path / "blanket.py"
    blanket.write_text("x = 1  # analysis: ignore\n")
    assert [f.rule for f in TA.audit_suppressions([str(blanket)])] == \
        ["stale-suppression"]


# --- the CLI -----------------------------------------------------------------

def test_cli_json_exit_codes(tmp_path):
    out = tmp_path / "findings.json"
    r = _run_cli("--json", str(out),
                 os.path.join(TFIX, "bad_hash_dedup.py"))
    assert r.returncode == 1
    assert [f["rule"] for f in json.loads(out.read_text())] == \
        ["hash-dedup"]
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    out2 = tmp_path / "clean.json"
    r = _run_cli("--json", str(out2), str(clean))
    assert r.returncode == 0
    assert json.loads(out2.read_text()) == []


def test_cli_artifacts(tmp_path):
    table = tmp_path / "budgets.md"
    progs = tmp_path / "programs.md"
    r = _run_cli("--budget-table", str(table), "--programs", str(progs),
                 os.path.join(TFIX, "bad_spec_k9.py"))
    assert r.returncode == 1                 # the fixture still fails
    assert table.read_text().startswith("# Hopper budget table")
    assert progs.read_text().startswith(
        "# Kernel-surface inventory of the port")


def test_changed_cli_paths_and_bad_ref():
    r = _run_cli("--changed", "HEAD",
                 os.path.join(TFIX, "bad_hash_dedup.py"))
    assert r.returncode == 2
    r = _run_cli("--changed", "no-such-ref-xyz")
    assert r.returncode == 2
    assert "--changed" in r.stderr


def _git(root, *args):
    subprocess.run(["git", "-c", "user.email=t@t.invalid",
                    "-c", "user.name=t", *args],
                   cwd=root, check=True, capture_output=True)


def test_changed_mode_agrees_with_full_run(tmp_path):
    """Over a touched-file subset, ``--changed``'s file set gives exactly
    the findings the full run attributes to those files: modified and
    untracked port files are in, committed-clean files and files that
    are not the port's are out."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "scripts"))
    os.makedirs(os.path.join(root, "comdb2_tpu_torch", "service"))
    clean = os.path.join(root, "scripts", "torch_clean.py")
    with open(clean, "w") as fh:
        fh.write("x = 1\n")
    tracked = os.path.join(root, "comdb2_tpu_torch", "service",
                           "svc.py")
    with open(tracked, "w") as fh:
        fh.write("def retire(p):\n    p.terminate()\n    p.wait()\n")
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")
    with open(tracked, "w") as fh:
        fh.write("def retire(p):\n    p.terminate()\n")
    new = os.path.join(root, "scripts", "torch_xfer_dispatch.py")
    with open(new, "w") as fh:
        fh.write("def push(items, dev):\n"
                 "    for it in items:\n        it.to(dev)\n")
    other = os.path.join(root, "scripts", "bench_other.py")
    with open(other, "w") as fh:
        fh.write("import multiprocessing\n")
    changed = TA.changed_files("HEAD", root=root)
    assert sorted(os.path.basename(p) for p in changed) == \
        ["svc.py", "torch_xfer_dispatch.py"]
    inc = {(os.path.basename(f.path), f.rule)
           for f in TA.run_paths(changed)}
    full = {(os.path.basename(f.path), f.rule)
            for f in TA.run_paths(TA.collect_files(root))
            if f.path in set(changed)}
    assert inc == full == {("svc.py", "wait-after-kill"),
                           ("torch_xfer_dispatch.py",
                            "per-item-transfer")}


# --- lifecycle and dataflow --------------------------------------------------

#: the lifecycle rules' pre-fix / post-fix excerpts (the JAX package's
#: review-round shapes): each pre-fix trips its rule, each post-fix none
LIFECYCLE_EXCERPTS = [
    ("deregister-before-close",
     "class D:\n    def _shutdown(self):\n        self._lsock.close()\n"
     "        self._pmux_withdraw()\n",
     "class D:\n    def _shutdown(self):\n        self._pmux_withdraw()\n"
     "        self._lsock.close()\n"),
    ("log-after-success",
     "class M:\n    def extend(self, ops):\n"
     "        self._log.append(tuple(ops))\n        self._closure(ops)\n",
     "class M:\n    def extend(self, ops):\n        self._closure(ops)\n"
     "        self._log.append(tuple(ops))\n"),
    ("release-in-finally",
     "class S:\n    def close(self):\n"
     "        out = self._client.stream_close(self.sid)\n"
     "        self._router._unpin(self._node)\n        return out\n",
     "class S:\n    def close(self):\n        try:\n"
     "            out = self._client.stream_close(self.sid)\n"
     "        finally:\n            self._router._unpin(self._node)\n"
     "        return out\n"),
    ("fresh-deadline-timestamp",
     "def _route(self, cls):\n    now = monotonic()\n"
     "    for name in self._ring.walk(cls):\n        try:\n"
     "            return self._dial(name)\n        except OSError:\n"
     "            self._blacklist[name] = now + self.ttl\n",
     "def _route(self, cls):\n"
     "    for name in self._ring.walk(cls):\n        try:\n"
     "            return self._dial(name)\n        except OSError:\n"
     "            self._blacklist[name] = monotonic() + self.ttl\n"),
]


@pytest.mark.parametrize("rule,bad,good", LIFECYCLE_EXCERPTS,
                         ids=[e[0] for e in LIFECYCLE_EXCERPTS])
def test_lifecycle_rules_catch_the_review_shapes(rule, bad, good):
    assert [f.rule for f in lifecycle.scan_file("<mem>.py", bad)] == \
        [rule]
    assert lifecycle.scan_file("<mem>.py", good) == []


def test_dataflow_deferred_finalize_exempt(tmp_path):
    """Readbacks in the DEFERRED finalize closure are the sanctioned
    pattern; a readback or a wait on the card on the beat itself is a
    finding, and so is a conversion of a stream-dispatch result."""
    inline = tmp_path / "inline_dispatch.py"
    inline.write_text(
        "import numpy as np\n"
        "import torch\n"
        "def pump(core):\n"
        "    out = core.stream_dispatch(core.batch)\n"
        "    torch.cuda.synchronize()\n"
        "    return np.asarray(out)\n")
    deferred = tmp_path / "deferred_dispatch.py"
    deferred.write_text(
        "import numpy as np\n"
        "def pump(core):\n"
        "    out = core.stream_dispatch(core.batch)\n"
        "    def finalize():\n"
        "        return np.asarray(out)\n"
        "    core.ring.append(finalize)\n")
    assert _pairs(dataflow.scan_files([str(inline)])) == \
        [("sync-readback-in-pump", 5), ("sync-readback-in-pump", 6)]
    assert dataflow.scan_files([str(deferred)]) == []


def test_dataflow_dtype_conversion_is_not_a_transfer(tmp_path):
    f = tmp_path / "loop_dispatch.py"
    f.write_text(
        "import torch\n"
        "def dispatch(items, dev):\n"
        "    for x in items:\n"
        "        x.to(torch.int64)\n"
        "        x.to(x.dtype)\n"
        "        x.to(dev)\n")
    assert _pairs(dataflow.scan_files([str(f)])) == \
        [("per-item-transfer", 6)]


def test_megabatch_kernel_lanes_upload_once(monkeypatch):
    """A fused kernel-rung beat uploads every lane's rows in ONE copy
    (the dataflow pass's first scan found one blocking copy per lane in
    ``MegaBatch._launch_kernel``), and the lanes' carries stay
    bit-equal to solo sessions."""
    import torch

    from comdb2_tpu_torch.ops import op as TO
    from comdb2_tpu_torch.stream import StreamSession
    from comdb2_tpu_torch.stream import engine as TE

    calls = []
    real = TE.upload

    def counting(array, device):
        calls.append(array.shape)
        return real(array, device)

    monkeypatch.setattr(TE, "upload", counting)
    beats = [[TO.invoke(0, "write", v), TO.ok(0, "write", v),
              TO.invoke(1, "read", None), TO.ok(1, "read", v)]
             for v in (1, 2, 3)]
    fused = [StreamSession("cas-register", engine="kernel", device="cpu")
             for _ in beats]
    solo = [StreamSession("cas-register", engine="kernel", device="cpu")
            for _ in beats]
    coll = TE.MegaBatch()
    fins = [s.append_stage(d, collector=coll)
            for s, d in zip(fused, beats)]
    coll.flush()
    [f() for f in fins]
    assert coll.fused_launches == 1 and len(calls) == 1, calls
    for s, d in zip(solo, beats):
        s.append(d)
    for f, s in zip(fused, solo):
        assert torch.equal(f._eng.ws, s._eng.ws)
        assert torch.equal(f._eng.stat, s._eng.stat)
        assert f.finalize_input() == s.finalize_input()


# --- the Hopper budget -------------------------------------------------------

def test_budget_accepts_every_production_tier():
    tiers = kernel_budget.production_tiers()
    assert len(tiers) > 100
    for bucket, P, K, spec in tiers:
        assert kernel_budget.check_spec(
            spec, where=f"{bucket} P={P} K={K}") == []
    assert kernel_budget.check_production() == []


@pytest.mark.parametrize("cfg,rule", [
    (dict(K=9), "hopper-k-cap"),
    (dict(P=16), "hopper-p-cap"),
    (dict(table_n=8193), "hopper-table-budget"),
    (dict(n_words=4), "hopper-key-words"),
    (dict(smem=232_449), "hopper-smem-budget"),
    (dict(warps=33), "hopper-cta-threads"),
])
def test_budget_rejects_known_bad(cfg, rule):
    findings = kernel_budget.check_config(**cfg)
    assert [f.rule for f in findings] == [rule]


@pytest.mark.parametrize("cfg", [
    dict(K=8, P=15, table_n=8192, n_words=3),
    dict(smem=232_448),
    dict(warps=32),
])
def test_budget_accepts_known_good(cfg):
    assert kernel_budget.check_config(**cfg) == []


def test_budget_rejects_a_spec_past_the_cta():
    """The widest spec at 8 warps over a full table fits; over a
    60,000-entry table it passes the shared memory a CTA may opt into.
    The narrowest spec fits at 32 warps, and 40 are over a CTA's
    threads."""
    wide = SK.spec_for(256, 8, 15, 8)
    assert kernel_budget.check_spec(wide) == []
    assert [f.rule for f in kernel_budget.check_spec(
        wide, table_n=60_000)] == ["hopper-smem-budget"]
    narrow = SK.spec_for(8, 32, 1, 1)
    assert kernel_budget.check_spec(narrow, table_n=32, warps=32) == []
    assert [f.rule for f in kernel_budget.check_spec(
        narrow, table_n=32, warps=40)] == ["hopper-cta-threads"]


def test_spec_for_keeps_the_meta_gates():
    k, p = kernel_budget.K_CAP + 1, kernel_budget.P_CAP + 1
    rows = SK.MAX_TABLE // 64 + 1
    assert SK.spec_for(8, 32, 3, k) is None
    assert SK.spec_for(8, 32, p, 1) is None
    assert SK.spec_for(rows, 64, 1, 1) is None


def test_budget_table_has_one_row_per_tier():
    table = kernel_budget.budget_table()
    assert table.startswith("# Hopper budget table (computed")
    assert len(table.splitlines()) - 4 == \
        len(kernel_budget.production_tiers())


@pytest.mark.parametrize("name,spec_args,table_n,warps,want", [
    # (a)'s layout: five processes renamed to six slots, K padded to 8,
    # its 6 x 36 table: per warp 2 words x (512 + 128) keys + 2 x 16
    # rows x 18 ints; the closure (128 x 7 -> 1024 keys) passes the
    # warp's 512, so the CTA holds a 2 x 1024-key buffer
    ("(a)", (6, 36, 6, 8), 216, 8,
     4 * (216 + 2 * 1024 + 8 * (2 * 640 + 2 * 16 * 18))),
    # the narrowest layout: one word, no CTA buffer (128 x 2 <= 512)
    ("narrow", (2, 2, 1, 2), 4, 1, 4 * (4 + 1 * 640 + 2 * 16 * 6)),
    # the widest: three words, a 2048-key CTA buffer, the full table
    ("widest", (256, 8, 15, 8), 8192, 8,
     4 * (8192 + 3 * 2048 + 8 * (3 * 640 + 2 * 16 * 18))),
])
def test_smem_bytes_equals_a_hand_count(name, spec_args, table_n, warps,
                                        want):
    spec = SK.spec_for(*spec_args)
    assert spec is not None, name
    assert kernel_budget.smem_bytes(spec, table_n, warps) == want


def test_a_layout_takes_68_kb_per_cta():
    """(a)'s layout at 8 warps over its table: 68,448 bytes, the 68 KB
    of PERF.md's kernel table."""
    spec = SK.spec_for(6, 36, 6, 8)
    assert (spec.P, spec.K, spec.n_words, spec.n_keys) == (6, 8, 2, 1024)
    assert kernel_budget.smem_bytes(spec, 216, 8) == 68_448


def test_constant_mirror_is_clean_and_catches_drift(tmp_path,
                                                    monkeypatch):
    defines = kernel_budget.cuda_defines(
        kernel_budget._kernel_source("seg_search.cu"))
    assert (defines["LANES"], defines["MAX_WARPS"], defines["RING"],
            defines["WARP_KEYS"]) == (SK.LANES, SK.WARPS_PER_CTA,
                                      kernel_budget.RING,
                                      kernel_budget.WARP_KEYS)
    ps = kernel_budget.cuda_defines(
        kernel_budget._kernel_source("pair_sort.cu"))
    from comdb2_tpu_torch.checker import pair_sort
    assert ps["PS_T"] == pair_sort.SMEM_N == 4096
    for mod in (SK, pair_sort, kernel_budget):
        assert kernel_budget.scan_file(mod.__file__) == []
    # a drifted source: MAX_WARPS 4
    src = open(kernel_budget._kernel_source("seg_search.cu")).read()
    drift = tmp_path / "seg_search.cu"
    drift.write_text(src.replace("#define MAX_WARPS 8",
                                 "#define MAX_WARPS 4"))
    monkeypatch.setattr(kernel_budget, "_kernel_source",
                        lambda name: str(drift))
    got = kernel_budget.scan_file(SK.__file__)
    assert [(f.rule, "WARPS_PER_CTA" in f.message) for f in got] == \
        [("cuda-constant-mirror", True)]


# --- the bucket audit --------------------------------------------------------

def test_fuzz_script_uses_the_declared_ladder():
    from comdb2_tpu_torch.analysis import bucket_audit

    src = os.path.join(REPO, "scripts", "torch_fuzz_seg.py")
    assert bucket_audit.scan_file(src) == []
    text = open(src).read()
    for ns, nt in kernel_budget.PRODUCTION_BUCKETS:
        assert f"({ns}, {nt})" in text
    assert bucket_audit.check_bucket_closure() == []


def test_ladder_is_the_jax_packages():
    from comdb2_tpu.analysis import pallas_budget

    assert kernel_budget.PRODUCTION_BUCKETS == \
        pallas_budget.PRODUCTION_BUCKETS
