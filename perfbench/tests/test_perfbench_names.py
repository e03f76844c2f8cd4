"""``BENCHMARK.json`` keeps to the characters, keys and references the
benchmark's contract allows, and every name it gives has its file."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(bench, group, keys):
    for e in bench[group]:
        assert set(e) == keys, e
        assert NAME.match(e["name"]), e["name"]
        assert _line(e["why"])


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            names.append(e["name"])
            assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in bench[group]}) == len(bench[group])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "perfbench", "traffic",
                               w["traffic"] + ".json")) as fh:
            kind = json.load(fh)["kind"]
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic",
                                           kind + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py")), m["name"]
    assert all(w["chips"] == 1 for w in bench["workloads"])
