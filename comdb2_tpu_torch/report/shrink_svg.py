"""Re-rendered counterexample SVG for shrink artifacts.

The counterpart of the JAX package's ``report/shrink_svg.py``. The
minimal sub-history is tiny by construction, so the render path
re-checks it on the HOST engine (no device call) and reuses the
existing counterexample renderers: the linear failing-window SVG
(:mod:`.linear_svg`) for the linearizability axis, the cycle ring
(:mod:`.txn_svg`) for the txn axis. Returning the re-check verdict
lets callers (``filetest --shrink``) assert the artifact is
still INVALID — a minimal.edn that re-checks clean would mean the
minimizer and the checker disagree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ..ops.op import Op


def render_minimal(ops: Sequence[Op], *, checker: str = "linear",
                   model: str = "cas-register",
                   realtime: bool = False):
    """Host re-check ``ops`` and render the counterexample SVG.
    Returns ``(valid?, svg_text | None)`` — the SVG is None when the
    re-check found nothing to draw (which callers should treat as a
    minimizer/checker disagreement worth surfacing)."""
    if checker == "txn":
        from ..txn import check_txn
        from . import txn_svg

        res = check_txn(list(ops), backend="host", realtime=realtime)
        cex = res.get("counterexample")
        svg = txn_svg.render_cycle(cex) if cex else None
        return res["valid?"], svg
    from ..checker import linear
    from ..models.model import MODELS
    from . import linear_svg

    # the host engine touches no device: name the CPU, so the re-check
    # runs on a host without a card too
    a = linear.analysis(MODELS[model](), list(ops), backend="host",
                        device="cpu")
    svg = (linear_svg.render_analysis(list(ops), a)
           if a.valid is False else None)
    return a.valid, svg


def results_map(result, reverified: Optional[Union[bool, str]] = None
                ) -> dict:
    """A :class:`~..shrink.core.ShrinkResult` as the
    ``results.edn`` map ``harness.store.save_shrink`` persists."""
    out = {
        "valid?": result.valid,
        "checker": result.checker,
        "seed-ops": result.seed_ops,
        "minimal-ops": result.n_ops,
        "rounds": result.rounds,
        "candidates": result.candidates,
        "dispatches": result.dispatches,
        "one-minimal?": result.one_minimal,
        "partial?": result.partial,
    }
    out.update({k.replace("_", "-"): v
                for k, v in result.extra.items()})
    if reverified is not None:
        out["reverified-valid?"] = reverified
    return out


__all__ = ["render_minimal", "results_map"]
