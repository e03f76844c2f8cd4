"""The port's kill-cluster CLI (``scripts/torch_killclustertest.py``)
against the JAX package's (``scripts/killclustertest.py``) on the same
small seeded runs: the same JSON line (the oracle diff: verdict, line
counts, first differing line, error) and the same exit code."""
from __future__ import annotations

import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clis():
    return (_load("torch_killclustertest",
                  os.path.join("scripts", "torch_killclustertest.py")),
            _load("killclustertest",
                  os.path.join("scripts", "killclustertest.py")))


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return rc, json.loads(out[0])


@pytest.mark.parametrize("argv,want_rc", [
    (["-n", "2000"], 0),
    (["-n", "500", "--chaos-fail", "0.3", "--seed", "4"], 2),
    (["-n", "500", "--chaos-unknown", "0.5", "--seed", "1"], 2),
    (["-n", "500", "--chaos-unknown", "0.5", "--seed", "2"], 0),
], ids=["clean", "rollback", "indeterminate", "survives-chaos"])
def test_same_oracle_diff_as_the_reference(clis, capsys, argv, want_rc):
    port, ref = clis
    got = _run(port, list(argv), capsys)
    want = _run(ref, list(argv), capsys)
    assert got == want
    assert got[0] == want_rc


def test_a_dropped_line_is_the_same_first_diff(clis, capsys,
                                               monkeypatch):
    """A transcript missing one row fails with exit 1 and the same first
    differing line in both packages."""
    from comdb2_tpu.harness import killcluster as JK

    from comdb2_tpu_torch.harness import killcluster as TK

    for mod in (TK, JK):
        inner = mod.scripted_workload

        def dropping(client, n_rows, inner=inner):
            for i, line in enumerate(inner(client, n_rows)):
                if i != 37:
                    yield line

        monkeypatch.setattr(mod, "scripted_workload", dropping)
    port, ref = clis
    got = _run(port, ["-n", "300"], capsys)
    want = _run(ref, ["-n", "300"], capsys)
    assert got == want
    assert got[0] == 1 and got[1]["valid?"] is False
    assert got[1]["first-diff"]["line"] == 37
