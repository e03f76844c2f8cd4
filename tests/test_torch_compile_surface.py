"""The port's kernel-surface prover (``analysis.compile_surface``) and
its runtime guard (``utils.compile_guard``), against the JAX package's
prover.

Contracts:

- the committed ``docs/programs_torch.md`` is what the prover renders;
- ladder parity: every ladder both inventories declare holds the same
  values in the port as in the JAX package;
- the kernel surface: the segment search at every production tier, the
  pair sort at the keys engine's row lengths, witnesses inside it;
- the ``unbucketed-dispatch-site`` rule is interprocedural, accepts
  sanctioned values, resolves the last dominating assignment and is
  suppressible;
- ``CompileGuard.offenders`` / ``assert_closed`` over the inventory, on
  synthetic ``note_launch`` records (the plain versions launch nothing
  on the CPU); the mixed workload on CPU tensors launches nothing and
  stays closed.
"""
from __future__ import annotations

import dataclasses
import os

import pytest

from comdb2_tpu.analysis import compile_surface as JCS

from comdb2_tpu_torch.analysis import compile_surface as CS
from comdb2_tpu_torch.analysis import kernel_budget
from comdb2_tpu_torch.checker import seg_kernel as SK
from comdb2_tpu_torch.utils import compile_guard as CG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TFIX = os.path.join(REPO, "tests", "fixtures", "analysis_torch")

#: ladders both inventories declare
SHARED_LADDERS = (
    "fuzz_buckets", "mesh_D", "service_n_pad", "service_S", "service_K",
    "service_P", "txn_N", "shrink_bucket", "shrink_B", "batch_B",
    "memo_dim", "mxu_table", "mxu_F", "mxu_chunk", "mxu_P", "mxu_words",
    "stream_delta", "stream_F", "stream_P", "stream_B", "wl_batch",
    "wl_reads", "wl_accounts", "wl_snaps", "wl_elems", "wl_nodes",
    "wl_values", "wl_delta")


# --- the static inventory ----------------------------------------------------

def test_programs_artifact_matches_committed():
    """Regenerating it is the fix when ladders change:
    ``python -m comdb2_tpu_torch.analysis --programs
    docs/programs_torch.md``."""
    committed = open(os.path.join(REPO, "docs",
                                  "programs_torch.md")).read()
    assert CS.render_programs() == committed


@pytest.mark.parametrize("key", SHARED_LADDERS)
def test_ladder_parity_with_the_jax_package(key):
    assert tuple(CS._ladders()[key]) == tuple(JCS._ladders()[key])


def test_service_limits_parity():
    port, ref = CS._ladders()["limits"], JCS._ladders()["limits"]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_inventory_covers_the_kernel_surface():
    inv = CS.static_inventory()
    variants = inv.variants()
    tiers = kernel_budget.production_tiers()
    for _, _, _, spec in tiers:
        lay = (spec.P, spec.K, spec.n_words)
        assert ("seg_search", lay) in variants
        assert ("seg_search_stream", lay) in variants
    lo, hi = inv.ladders["pair_sort_N"]
    assert (lo, hi) == (32, 524288)
    assert {lay for k, lay in variants if k == "pair_sort"} == \
        {1 << i for i in range(5, 20)}
    assert {s.kernel for s in inv.sites} == set(CG.LAUNCHES)


def test_witnesses_land_inside_the_inventory():
    rows = CS.witness_table()
    assert [r[0] for r in rows] == ["seg-search"] * 2 \
        + ["seg-search-stream"] * 2 + ["pair-sort"] * 2
    assert rows[1][2] == "('seg_search', (15, 8, 3))"
    assert rows[-1][2] == "('pair_sort', 524288)"
    assert CS.check_witnesses() == []


# --- the runtime guard -------------------------------------------------------

@pytest.fixture()
def fresh_counters(monkeypatch):
    """The guard's counters, isolated from the rest of the process."""
    monkeypatch.setattr(CG, "LAUNCHES", dict.fromkeys(CG.LAUNCHES, 0))
    monkeypatch.setattr(CG, "VARIANTS", {})


def test_guard_over_synthetic_launches(fresh_counters):
    inv = CS.static_inventory()
    spec = SK.spec_for(8, 32, 4, 2)
    with CG.guard() as g:
        CG.note_launch("seg_search_stream", (spec.P, spec.K,
                                             spec.n_words))
        CG.note_launch("seg_search", (spec.P, spec.K, spec.n_words))
        CG.note_launch("pair_sort", 4096)
        CG.note_launch("pair_sort", 4096)
    assert g.variants() == {("seg_search_stream", (4, 2, 1)): 1,
                            ("seg_search", (4, 2, 1)): 1,
                            ("pair_sort", 4096): 2}
    assert g.offenders(inv.variants()) == []
    g.assert_closed(inv.variants())
    assert g.counters()["launches"] == {"seg_search": 1,
                                        "seg_search_stream": 1,
                                        "pair_sort": 2}


@pytest.mark.parametrize("kernel,layout", [
    ("pair_sort", CS.UNBUCKETED_PAIR_SORT_N),
    ("pair_sort", 1 << 20),
    ("seg_search", (6, 2, 1)),         # no production tier packs P=6
    ("seg_search_stream", (16, 2, 3)),  # over the kernel's 15 slots
])
def test_guard_catches_an_unbucketed_launch(fresh_counters, kernel,
                                            layout):
    inv = CS.static_inventory()
    with CG.guard() as g:
        CG.note_launch("pair_sort", 4096)
        CG.note_launch(kernel, layout)
    assert g.offenders(inv.variants()) == [(kernel, layout)]
    assert inv.offenders(g.variants()) == [(kernel, layout)]
    with pytest.raises(CG.CompileSurfaceError, match=kernel):
        g.assert_closed(inv.variants())


def test_mixed_workload_on_cpu_launches_nothing(fresh_counters):
    """On CPU tensors the workload runs the plain versions end to end:
    no launch, no variant, the guard closed; the unbucketed control
    needs the card."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = CS.mixed_workload("cpu")
    finally:
        torch.set_num_threads(n)
    assert res["variants"] == {} and res["control"] is None
    assert res["counters"]["launches"] == dict.fromkeys(CG.LAUNCHES, 0)
    assert res["shrink_steps"] >= 1


def test_mixed_workload_on_the_card_raises_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the card half runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CS.mixed_workload("cuda")


def test_check_built_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the card half runs")
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_budget.check_built()


# --- the unbucketed-dispatch-site rule ---------------------------------------

def test_unbucketed_rule_is_interprocedural():
    path = os.path.join(TFIX, "bad_unbucketed_dispatch.py")
    findings = CS.scan_files([path])
    assert {f.rule for f in findings} == {"unbucketed-dispatch-site"}
    msgs = " ".join(f.message for f in findings)
    assert "via _dispatch" in msgs
    assert "len(" in msgs


def test_unbucketed_rule_accepts_sanctioned_values(tmp_path):
    p = tmp_path / "ok_site.py"
    p.write_text(
        "from comdb2_tpu_torch.checker.batch import check_batch\n"
        "from comdb2_tpu_torch.stream.engine import pad_sizes\n"
        "from comdb2_tpu_torch.utils import next_pow2\n"
        "def serve(batch, items, memo, sb):\n"
        "    check_batch(batch, s_pad=64,\n"
        "                n_states_pad=next_pow2(len(items)))\n"
        "    ns = pad_sizes(memo.n_states, memo.n_transitions)[0]\n"
        "    return sb.stream_dispatch(n_states=ns)\n")
    assert CS.scan_files([str(p)]) == []


def test_unbucketed_rule_uses_last_dominating_assignment(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text(
        "from comdb2_tpu_torch.utils import next_pow2\n"
        "def serve(batch, items):\n"
        "    n = len(items)\n"
        "    n = next_pow2(n)\n"
        "    return check_batch(batch, s_pad=n)\n")
    assert CS.scan_files([str(clean)]) == []
    rawed = tmp_path / "rawed.py"
    rawed.write_text(
        "from comdb2_tpu_torch.utils import next_pow2\n"
        "def serve(batch, items):\n"
        "    n = next_pow2(8)\n"
        "    n = len(items)\n"
        "    return check_batch(batch, s_pad=n)\n")
    assert [f.rule for f in CS.scan_files([str(rawed)])] == \
        ["unbucketed-dispatch-site"]


def test_unbucketed_rule_suppressible(tmp_path):
    p = tmp_path / "sup_site.py"
    p.write_text(
        "def serve(batch, items):\n"
        "    return check_batch(batch, s_pad=len(items))"
        "  # analysis: ignore[unbucketed-dispatch-site]\n")
    assert CS.scan_files([str(p)]) == []
    assert CS.scan_files([str(p)], apply_suppressions=False) != []


def test_the_sharded_batch_site_is_the_decided_finding():
    """``checker/batch.py``'s mesh route passes the raw batch width at
    D = 1 (by design: no kernel layout depends on B); the rule sees
    it, and its marker holds it."""
    path = os.path.join(REPO, "comdb2_tpu_torch", "checker", "batch.py")
    raw = CS.scan_files([path], apply_suppressions=False)
    assert [(f.rule, "check_device_keys_sharded(B=" in f.message)
            for f in raw] == [("unbucketed-dispatch-site", True)]
    assert CS.scan_files([path]) == []
