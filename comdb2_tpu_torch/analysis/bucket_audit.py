"""Shape-bucket closure audit — the counterpart of the JAX package's
``analysis/jaxpr_audit.py``.

Production code buckets every shape that reaches a dispatch (pow2 pads,
the fixed fuzz bucket ladder), so a kernel's layout and every table
buffer come from a closed set. This pass enforces that statically:

- :func:`scan_files` — AST scan of the fuzz script
  (``scripts/torch_fuzz_seg.py``) and the driver
  (``comdb2_tpu_torch/checker/linear.py``): ``bucket = (a, b)``
  literals must come from the declared ladder; literal ``s_pad`` /
  ``k_pad`` values at ``make_segments`` call sites must be powers of
  two (non-literal pads route through ``next_pow2``); literal
  ``n_states`` / ``n_transitions`` at engine entry calls must be
  bucketed.
- :func:`check_bucket_closure` — the declared ladder must be closed
  under the kernel gate: every bucket fits ``seg_kernel.spec_for`` and
  the table budget, so no family silently falls off the kernel.

The JAX package's ``trace_entry_points`` and
``duplicated_cond_branches`` have nothing to trace here: eager PyTorch
builds no jaxpr and no ``lax.cond``, so there is no sub-program that
could be duplicated under two branches. The rule ids stay the JAX
package's (``jaxpr-unbucketed-shape``, ``jaxpr-bucket-closure``) so a
finding reads the same in both packages.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from . import Finding, suppressed
from .kernel_budget import (PRODUCTION_BUCKETS, _fold, _fold_tuple,
                            _module_consts)

#: pads the fuzz script may use literally (everything else must route
#: through next_pow2)
DECLARED_PADS = {"s_pad": {64}, "k_pad": {8}}

K_PAD = 8

#: engine entry points whose literal table dims must be bucketed
ENTRY_CALL_NAMES = {"check_device_seg", "check_device_seg2",
                    "check_device_seg_kernel", "check_device_seg_batch",
                    "stream_dispatch", "pad_succ"}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def scan_file(path: str, source: Optional[str] = None, *,
              apply_suppressions: bool = True) -> List[Finding]:
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []
    lines = source.splitlines()
    env = _module_consts(tree)
    raw: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "bucket":
            dims = _fold_tuple(node.value, env)
            if dims is not None and len(dims) == 2 \
                    and tuple(dims) not in PRODUCTION_BUCKETS:
                raw.append(Finding(
                    "jaxpr-unbucketed-shape", path, node.lineno,
                    f"bucket {dims} is not in the declared ladder "
                    f"{list(PRODUCTION_BUCKETS)} — an unbucketed shape "
                    "puts each seed on a table and kernel layout of "
                    "its own"))
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            (fn.id if isinstance(fn, ast.Name) else "")
        if name == "make_segments":
            for kw in node.keywords:
                if kw.arg in DECLARED_PADS:
                    v = _fold(kw.value, env)
                    if v is not None and not _is_pow2(v):
                        raw.append(Finding(
                            "jaxpr-unbucketed-shape", path,
                            node.lineno,
                            f"{kw.arg}={v} is not a power of two — "
                            "pads must be bucketed (next_pow2) so "
                            "histories share buffers and layouts"))
        elif name in ENTRY_CALL_NAMES:
            for kw in node.keywords:
                if kw.arg in ("n_states", "n_transitions"):
                    v = _fold(kw.value, env)
                    if v is not None and not _is_pow2(v):
                        raw.append(Finding(
                            "jaxpr-unbucketed-shape", path,
                            node.lineno,
                            f"{kw.arg}={v} at an engine entry is not a "
                            "pow2 bucket — shape buckets must be "
                            "closed"))
    if not apply_suppressions:
        return raw
    return [f for f in raw if not suppressed(lines, f.line, f.rule)]


def scan_files(paths: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        if os.path.exists(p):
            out += scan_file(p)
    return out


def check_bucket_closure() -> List[Finding]:
    """The declared ladder must be kernel-eligible end to end: every
    bucket fits the kernel's table budget and ``spec_for`` accepts it
    at P = 4, K = ``K_PAD``, so no family silently falls off the
    kernel path."""
    from ..checker import seg_kernel as SK

    path = SK.__file__
    out: List[Finding] = []
    for ns, nt in PRODUCTION_BUCKETS:
        if ns * nt > SK.MAX_TABLE:
            out.append(Finding(
                "jaxpr-bucket-closure", path, 0,
                f"bucket ({ns},{nt}) exceeds the kernel table budget "
                f"MAX_TABLE={SK.MAX_TABLE}"))
            continue
        if SK.spec_for(ns, nt, 4, K_PAD) is None:
            out.append(Finding(
                "jaxpr-bucket-closure", path, 0,
                f"bucket ({ns},{nt}) is rejected by spec_for at "
                f"P=4/K={K_PAD} — the fuzz ladder and the kernel gate "
                "have drifted apart"))
    return out


from . import Pass, register_pass  # noqa: E402


def _repo_stage(ctx):
    out = scan_files(
        [os.path.join(ctx["root"], "scripts", "torch_fuzz_seg.py"),
         os.path.join(ctx["root"], "comdb2_tpu_torch", "checker",
                      "linear.py")])
    return out + check_bucket_closure()


register_pass(Pass(
    name="bucket-audit",
    scan_paths=scan_files,
    raw_file=lambda path, source: scan_file(
        path, source, apply_suppressions=False),
    repo_stage=_repo_stage,
))


__all__ = ["check_bucket_closure", "scan_file", "scan_files"]
