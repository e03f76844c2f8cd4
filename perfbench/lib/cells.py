"""Find a cell and what belongs to it, by the names ``BENCHMARK.json``
gives, under a checkout's root.

A cell (an entry of ``workloads``) names a configuration, whose entry
in ``configs`` gives its file, and a traffic mix, the data file
``perfbench/traffic/<traffic>.json``; the mix's ``kind`` is the caller
``perfbench/traffic/<kind>.py``. A metric is read by
``perfbench/metrics/<name>.py``. A later cell, mix, caller or metric is
added as files and entries, with no edit to the harness.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import List

PKG = "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    root: str
    config: dict
    traffic: dict
    end_to_end: List[dict]       # this cell's end-to-end metrics
    per_layer: List[dict]        # this cell's per-layer metrics

    def caller(self):
        """The module of the traffic mix's ``kind``."""
        return load_module(self.root, "traffic", self.traffic["kind"])

    def reader(self, metric: str):
        """The module that reads the metric ``metric``."""
        return load_module(self.root, "metrics", metric)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, PKG, "traffic",
                           w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return Cell(name, int(w["chips"]), root, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_module(root: str, folder: str, name: str):
    """``<root>/perfbench/<folder>/<name>.py`` as a module (the name may
    hold dots, so it is loaded from its path)."""
    path = os.path.join(root, PKG, folder, name + ".py")
    key = f"{PKG}._{folder}.{name.replace('.', '_')}@{abs(hash(root))}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
