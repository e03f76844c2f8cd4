"""Reporting: counterexample SVGs, rendered natively with no external
processes (the role of ``knossos/linear/report.clj``).

The part of the JAX package's ``report`` package that the checkers and
the shrink artifacts need: :mod:`.svg` (the SVG document),
:mod:`.linear_svg` (a failed linearizability analysis),
:mod:`.txn_svg` (a dependency cycle) and :mod:`.shrink_svg` (a minimal
sub-history, re-checked on the host). Each writes the same bytes as
the JAX package's module of the same name. Not ported yet: the latency
and rate graphs, the timeline and the service SVG.
"""

from . import linear_svg, shrink_svg, svg, txn_svg

__all__ = ["linear_svg", "shrink_svg", "svg", "txn_svg"]
