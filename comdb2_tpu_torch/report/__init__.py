"""Reporting: latency and rate graphs (``jepsen/checker/perf.clj``),
HTML timelines (``checker/timeline.clj``), and counterexample SVGs
(``knossos/linear/report.clj``) — all rendered natively as SVG/HTML,
with no gnuplot or external processes.

The counterpart of the JAX package's ``report`` package: :mod:`.svg`
(the SVG document), :mod:`.perf` (latency and rate graphs),
:mod:`.timeline`, :mod:`.linear_svg` (a failed linearizability
analysis), :mod:`.txn_svg` (a dependency cycle) and :mod:`.shrink_svg`
(a minimal sub-history, re-checked on the host) and
:mod:`.service_svg` (the verifier daemon's latency timeline). Each
writes the same bytes as the JAX package's module of the same name. The
graph checkers mirror ``checker.clj``'s ``latency-graph``,
``rate-graph`` and ``perf``.
"""

from __future__ import annotations

import os
from typing import Optional

from ..checker.checkers import Checker, compose
from . import linear_svg, perf, shrink_svg, svg, timeline, txn_svg


def _outdir(test: dict, opts: Optional[dict]) -> Optional[str]:
    base = (opts or {}).get("dir") or test.get("dir")
    if base is None and test.get("name") and test.get("start-time"):
        # default to the test's store directory, like store/path!
        from ..harness import store
        base = store.path(test)
    sub = (opts or {}).get("subdirectory")
    if base is None:
        return None
    return os.path.join(base, sub) if sub else base


class LatencyGraph(Checker):
    """Writes latency-raw.svg and latency-quantiles.svg
    (``checker.clj:288-295``)."""

    def check(self, test, model, history, opts=None):
        d = _outdir(test, opts)
        perf.point_graph(test, history,
                         os.path.join(d, "latency-raw.svg") if d else None)
        perf.quantiles_graph(
            test, history,
            os.path.join(d, "latency-quantiles.svg") if d else None)
        return {"valid?": True}


class RateGraph(Checker):
    """Writes rate.svg (``checker.clj:297-302``)."""

    def check(self, test, model, history, opts=None):
        d = _outdir(test, opts)
        perf.rate_graph(test, history,
                        os.path.join(d, "rate.svg") if d else None)
        return {"valid?": True}


class Timeline(Checker):
    """Writes timeline.html (``timeline.clj:92-111``)."""

    def check(self, test, model, history, opts=None):
        d = _outdir(test, opts)
        timeline.html(test, history,
                      os.path.join(d, "timeline.html") if d else None)
        return {"valid?": True}


def latency_graph() -> LatencyGraph:
    return LatencyGraph()


def rate_graph() -> RateGraph:
    return RateGraph()


def perf_checker():
    """latency + rate graphs composed (``checker.clj:304-308``)."""
    return compose({"latency-graph": latency_graph(),
                    "rate-graph": rate_graph()})


__all__ = ["perf", "timeline", "linear_svg", "shrink_svg", "svg",
           "txn_svg", "latency_graph", "rate_graph", "perf_checker",
           "LatencyGraph", "RateGraph", "Timeline"]
