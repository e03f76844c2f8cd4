"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have (no cell has a batch or an exchange
between chips), and when a control stands in the program's place. Each run skips the harness's look for a card and runs
the rest on CPU tensors, at a size a test can hold."""

import pytest

from perfbench.lib import cells, harness

CELLS = ("ctest5p.single", "register10p.indep")
SEED = 2**31 + 77


def _run(root, cell):
    return harness.run_cell(cells.load(root, cell), SEED, 2.0, False,
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    r = _run(small_root, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_traced_run_is_correct(small_root, cell):
    r = harness.run_cell(cells.load(small_root, cell), SEED, 2.0, True,
                         device="cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["invalid_compared"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(small_root, cell, monkeypatch):
    """The failing index of every INVALID verdict moved by one."""
    from comdb2_tpu_torch.checker import linear

    real = linear._device_verdict

    def shifted(*a, **kw):
        out = real(*a, **kw)
        if out.valid is False:
            out.op_index += 1
        return out

    monkeypatch.setattr(linear, "_device_verdict", shifted)
    r = _run(small_root, cell)
    assert not r["correct"] and r["checks"]["mismatched"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_step_returns_its_state_unchanged(small_root, cell, monkeypatch):
    """The segment search hands back the carry it was given: every
    history and every key comes out VALID."""
    from comdb2_tpu_torch.checker import seg_kernel as SK

    def unchanged(seg, off, stride, ws, stat, table, spec, work=None,
                  results=None):
        status, fail, n, _ = (int(x) for x in stat.tolist())
        return status, fail, n, ws

    monkeypatch.setattr(SK, "seg_search_reference", unchanged)
    r = _run(small_root, cell)
    assert not r["correct"] and r["checks"]["mismatched"]["value"] > 0


def test_ladder_step_returns_its_state_unchanged(small_root, monkeypatch):
    """The seg2 ladder, which takes every test of ``register10p.indep``
    past the kernel's frontier, hands back its starting state: VALID at
    the first rung."""
    from comdb2_tpu_torch.checker import linear_torch as LT

    monkeypatch.setattr(LT, "check_device_seg2",
                        lambda *a, **kw: (LT.VALID, -1, 1))
    r = _run(small_root, "register10p.indep")
    assert not r["correct"] and r["checks"]["mismatched"]["value"] > 0


def _no_report(ce):
    return None


def _config_moved(ce):
    ce.configs[0] = {**ce.configs[0], "model": "CASRegister(value=7)"}
    return ce


def _path_cut(ce):
    ce.paths = [p[:-1] for p in ce.paths]
    return ce


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_no_report, _config_moved, _path_cut])
def test_counterexample_altered_where_produced(small_root, cell, fault,
                                               monkeypatch):
    """The counterexample of every INVALID verdict dropped (the verdict
    and index stand), one of its configs given another value, or each of
    its paths cut before the step that the model forbids."""
    from comdb2_tpu_torch.checker import counterexample as CE

    real = CE.reconstruct

    def altered(*a, **kw):
        ce = real(*a, **kw)
        return None if ce is None else fault(ce)

    monkeypatch.setattr(CE, "reconstruct", altered)
    r = _run(small_root, cell)
    assert r["checks"]["mismatched"]["value"] == 0, r["checks"]
    assert not r["correct"]
    assert r["checks"]["counterexample_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name,number", [("unindexed", "mismatched"),
                                         ("unreported",
                                          "counterexample_wrong")])
def test_control_is_not_correct(small_root, name, number, cell):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "perfbench_control", os.path.join(small_root, "perfbench",
                                          "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    r = control.control_run(cells.load(small_root, cell), SEED, 6, name)
    assert not r["correct"]
    assert r["checks"][number]["value"] >= 1
