"""The kernel-surface prover — the counterpart of the JAX package's
``analysis/compile_surface.py``.

What compiles in the JAX package is one XLA or Mosaic program per
input shape, so its prover enumerates programs. The port runs eagerly:
each CUDA source is built once by ``nvcc``, and every launch passes its
layout at run time. So the surface to hold closed is the set of
(kernel, layout) variants the hand-written kernels are launched at —
``(seg_search | seg_search_stream, (P, K, n_words))`` for the segment
search, ``(pair_sort, N)`` for the pair sort — and the ladders every
shape on the serving surface is drawn from. Four parts:

- :func:`static_inventory` — the declared ladders (service buckets
  from :class:`~..service.bucketing.ServiceLimits`, the txn N floor,
  shrink's pow2 kept-op buckets and batch cap, the MXU caps, the mesh
  width, the stream and workload ladders) and the kernel surface: the
  segment search at every production tier
  (:func:`.kernel_budget.production_tiers`) and the pair sort at every
  row length the keys engine sorts. :meth:`Inventory.variants` is the
  set :meth:`~..utils.compile_guard.CompileGuard.assert_closed` takes.
- :func:`witness_table` — per kernel site, the (kernel, layout) its
  smallest and largest rung would launch, computed through
  ``spec_for``: a pure function (the JAX package's counterpart traces
  with ``jax.eval_shape``; eager PyTorch has nothing to trace).
- :func:`scan_files` — the ``unbucketed-dispatch-site`` rule: shape
  arguments of the batch / serving dispatch sites must come from a
  declared ladder; interprocedural (a parameter is chased through the
  call graph to every call site). Only PROVABLY-raw values are flagged
  (``len(...)``, ``.shape[...]``, raw memo counts, non-pow2 literals).
- :func:`mixed_workload` — the runtime half on the card: a mixed
  workload through both kernels under
  :func:`~..utils.compile_guard.guard`, held inside the inventory, and
  a deliberately unbucketed pair-sort row that must be caught.

:func:`render_programs` writes the inventory as the checked-in
``docs/programs_torch.md`` (drift is a test failure).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from . import Finding, suppressed


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _pow2s(lo: int, hi: int) -> Tuple[int, ...]:
    out, v = [], 1
    while v <= hi:
        if v >= lo:
            out.append(v)
        v <<= 1
    return tuple(out)


#: the keys engine's frontier capacities F: what the port's callers
#: pass ``check_batch`` (the tests' 8 to the escalation's 8192) —
#: its block sort rows are ``next_pow2(F (P + 1))`` wide
KEYS_F = (8, 8192)
#: the keys engine's slot widths: pow2 (``check_batch`` buckets P), at
#: most what its 62-bit key layout holds
KEYS_P = (2, 32)


# --- the inventory ----------------------------------------------------------

@dataclass(frozen=True)
class Site:
    """One kernel dispatch site: the compile-guard kernel name it
    launches under and the declared layouts it may launch at."""

    key: str
    kernel: str
    note: str
    layouts: FrozenSet
    axes_doc: str = ""

    def variants(self) -> FrozenSet:
        return frozenset((self.kernel, lay) for lay in self.layouts)


@dataclass(frozen=True)
class Inventory:
    """The static kernel-surface inventory plus the declared ladders
    (which render into the artifact and hold the JAX package's ladders
    to the port's)."""

    sites: Tuple[Site, ...]
    ladders: dict = field(default_factory=dict, compare=False)

    def variants(self) -> FrozenSet:
        """Every declared ``(kernel, layout)`` pair."""
        out: set = set()
        for s in self.sites:
            out |= s.variants()
        return frozenset(out)

    def offenders(self, launched) -> list:
        """The launched ``(kernel, layout)`` pairs OUTSIDE the declared
        surface."""
        decl = self.variants()
        return sorted((v for v in launched if v not in decl), key=repr)


def _ladders() -> dict:
    """Every closed value set, derived from the DECLARED constants —
    never from observed traffic. Keys shared with the JAX package's
    ``_ladders`` hold the same values."""
    from ..checker import mxu
    from ..checker.linear_torch import make_pack_plan
    from ..checker.wl import batch as wl_batch
    from ..service.bucketing import ServiceLimits
    from ..service.sharding import MAX_SHARDS
    from ..shrink.verdicts import MAX_BATCH, MIN_BUCKET
    from ..stream import engine as stream_engine
    from ..txn.edges import TXN_N_FLOOR
    from ..utils import next_pow2
    from .kernel_budget import PRODUCTION_BUCKETS, production_tiers

    lim = ServiceLimits()
    specs = [spec for _, _, _, spec in production_tiers()]
    mxu_words = sorted({
        plan.n_words
        for ns in (1 << i for i in range(mxu.S_CAP.bit_length()))
        for nt in (1 << i for i in range(mxu.T_CAP.bit_length()))
        for P in range(1, mxu.MAX_P + 1)
        for plan in (make_pack_plan(ns, nt, P),)
        if plan is not None})
    return {
        "limits": lim,
        "fuzz_buckets": tuple(PRODUCTION_BUCKETS),
        "specs": specs,
        "mesh_D": (1, MAX_SHARDS),
        "kernel_P": tuple(sorted({s.P for s in specs})),
        "kernel_K": tuple(sorted({s.K for s in specs})),
        "kernel_words": tuple(sorted({s.n_words for s in specs})),
        "service_n_pad": (16, next_pow2(lim.max_ops)),
        "service_S": (8, next_pow2(lim.max_segments)),
        "service_K": (2, next_pow2(lim.max_invokes_per_seg)),
        "service_P": (2, next_pow2(lim.max_processes)),
        "txn_N": (TXN_N_FLOOR, 1 << 16),
        "shrink_bucket": (MIN_BUCKET, next_pow2(lim.max_ops)),
        "shrink_B": (1, MAX_BATCH),
        "batch_B": (1, 1 << 12),
        "memo_dim": (1, 1 << 20),
        "mxu_table": (mxu.S_CAP, mxu.T_CAP),
        "mxu_F": tuple(mxu.CAPACITIES),
        "mxu_chunk": (64, mxu.CHUNK),
        "mxu_P": (mxu.MIN_P, mxu.MAX_P),
        "mxu_words": tuple(mxu_words),
        "stream_delta": tuple(stream_engine.DELTA_PADS),
        "stream_F": tuple(stream_engine.STREAM_CAPACITIES),
        "stream_P": tuple(range(2, mxu.MAX_P + 1, 2)),
        "stream_B": tuple(stream_engine.MEGABATCH_LANES),
        "wl_batch": tuple(wl_batch.WL_BATCH),
        "wl_reads": tuple(wl_batch.WL_READS),
        "wl_accounts": tuple(wl_batch.WL_ACCOUNTS),
        "wl_snaps": tuple(wl_batch.WL_SNAPS),
        "wl_elems": tuple(wl_batch.WL_ELEMS),
        "wl_nodes": tuple(wl_batch.WL_NODES),
        "wl_values": tuple(wl_batch.WL_VALUES),
        "wl_delta": tuple(wl_batch.WL_DELTA_PADS),
        "pair_sort_N": (next_pow2(KEYS_F[0] * (KEYS_P[0] + 1)),
                        next_pow2(KEYS_F[1] * (KEYS_P[1] + 1))),
    }


def static_inventory() -> Inventory:
    """Build the declared kernel surface (pure host work: no device)."""
    L = _ladders()
    seg_layouts = frozenset((s.P, s.K, s.n_words) for s in L["specs"])
    seg_doc = (f"P in {list(L['kernel_P'])}; K in {list(L['kernel_K'])}; "
               f"n_words in {list(L['kernel_words'])} — the "
               f"{len(seg_layouts)} (P, K, n_words) triples of the "
               f"{len(L['specs'])} production tiers")
    lo, hi = L["pair_sort_N"]
    sites = (
        Site(
            key="seg-search",
            kernel="seg_search",
            note="segment-search kernel, carry mode "
                 "(`checker/seg_kernel.seg_search`): one warp runs one "
                 "history's segments, or a chunk of them, from a carry "
                 "— the single-history driver (`checker/linear.py`), "
                 "the stream sessions' kernel rung, the counterexample "
                 "re-scan. Its layout is the `SegKernelSpec` that "
                 "`spec_for` gives the history's table and slots; the "
                 "declared layouts are the production tiers "
                 "(`analysis.kernel_budget.production_tiers`)",
            layouts=seg_layouts, axes_doc=seg_doc),
        Site(
            key="seg-search-stream",
            kernel="seg_search_stream",
            note="segment-search kernel, stream mode "
                 "(`checker/seg_kernel.seg_search_stream`): a batch "
                 "packed into RESET-marked group streams, one warp each "
                 "— `checker.batch.check_batch`'s stream engine, the "
                 "service ring, shrink rounds, the harness's keyed "
                 "checks. Same layouts as the carry mode",
            layouts=seg_layouts, axes_doc=seg_doc),
        Site(
            key="pair-sort",
            kernel="pair_sort",
            note="pair-sort kernel (`checker/pair_sort.pair_sort`): the "
                 "keys engine's per-batch block sort "
                 "(`linear_torch._k_dedup`), rows of "
                 "`next_pow2(F (P + 1))` pairs for the engine's "
                 f"frontier F in {KEYS_F[0]}..{KEYS_F[1]} and pow2 slot "
                 f"width P in {KEYS_P[0]}..{KEYS_P[1]}",
            layouts=frozenset(_pow2s(lo, hi)),
            axes_doc=f"N in pow2 {lo}..{hi}"),
    )
    return Inventory(sites=sites, ladders=L)


# --- witnesses --------------------------------------------------------------

def witness_table() -> List[Tuple[str, str, str]]:
    """``(site, witness, (kernel, layout))`` rows: per kernel site, the
    variant its smallest and its largest rung would launch, computed
    through ``spec_for`` (and ``next_pow2`` for the pair sort) — a pure
    function of the declared ladders. Raises when a rung no longer maps
    into the inventory."""
    from ..checker import seg_kernel as SK
    from ..utils import next_pow2
    from .kernel_budget import K_CAP, P_CAP, PRODUCTION_BUCKETS

    inv = static_inventory()
    rows = []
    small, large = PRODUCTION_BUCKETS[0], PRODUCTION_BUCKETS[-1]
    for site in ("seg-search", "seg-search-stream"):
        kernel = inv.sites[0 if site == "seg-search" else 1].kernel
        for (ns, nt), P, K in ((small, 1, 1), (large, P_CAP, K_CAP)):
            spec = SK.spec_for(ns, nt, P, K)
            if spec is None:
                raise RuntimeError(f"{site}: spec_for({ns},{nt},{P},{K}) "
                                   "refuses a declared rung")
            v = (kernel, (spec.P, spec.K, spec.n_words))
            if v not in inv.variants():
                raise RuntimeError(f"{site}: {v} is outside the "
                                   "inventory")
            rows.append((site, f"spec_for({ns},{nt},P={P},K={K})",
                         repr(v)))
    for F, P in ((KEYS_F[0], KEYS_P[0]), (KEYS_F[1], KEYS_P[1])):
        v = ("pair_sort", next_pow2(F * (P + 1)))
        if v not in inv.variants():
            raise RuntimeError(f"pair-sort: {v} is outside the "
                               "inventory")
        rows.append(("pair-sort", f"keys engine at F={F}, P={P}",
                     repr(v)))
    return rows


def check_witnesses() -> List[Finding]:
    """The witness table as findings: a declared rung that no longer
    maps into the inventory is a ``compile-surface-witness`` finding."""
    try:
        witness_table()
    except Exception as e:          # a broken ladder IS a finding
        return [Finding("compile-surface-witness", __file__, 0,
                        f"{type(e).__name__}: {e}")]
    return []


# --- the docs/programs_torch.md artifact ------------------------------------

def render_programs() -> str:
    """The kernel-surface inventory as a deterministic markdown artifact
    (the drift contract of ``docs/programs_torch.md``: the tests
    regenerate it and any diff is a failure)."""
    inv = static_inventory()
    L = inv.ladders
    lim = L["limits"]
    out = [
        "# Kernel-surface inventory of the port",
        "",
        "Generated by `python -m comdb2_tpu_torch.analysis --programs "
        "docs/programs_torch.md`;",
        "checked by `tests/test_torch_compile_surface.py` (drift = "
        "failure). The port",
        "builds each CUDA source once and passes every layout at run "
        "time, so what",
        "must stay closed is the set of (kernel, layout) variants the "
        "hand-written",
        "kernels are launched at; the runtime guard",
        "(`comdb2_tpu_torch.utils.compile_guard`) asserts the launched "
        "variants stay a",
        "subset (`analysis.compile_surface.mixed_workload` on the card).",
        "",
        "## Declared ladders",
        "",
        "| ladder | values | source |",
        "|---|---|---|",
        f"| fuzz kernel buckets | {list(L['fuzz_buckets'])} | "
        "`analysis.kernel_budget.PRODUCTION_BUCKETS` |",
        f"| service n_pad | pow2 {L['service_n_pad'][0]}.."
        f"{L['service_n_pad'][1]} | `ServiceLimits.max_ops="
        f"{lim.max_ops}` |",
        f"| service S | pow2 {L['service_S'][0]}..{L['service_S'][1]}"
        f" | `ServiceLimits.max_segments={lim.max_segments}` |",
        f"| service K | pow2 {L['service_K'][0]}..{L['service_K'][1]}"
        f" | `ServiceLimits.max_invokes_per_seg="
        f"{lim.max_invokes_per_seg}` |",
        f"| service P | pow2 {L['service_P'][0]}..{L['service_P'][1]}"
        f" | `ServiceLimits.max_processes={lim.max_processes}` |",
        f"| txn closure N | pow2 {L['txn_N'][0]}..{L['txn_N'][1]} | "
        f"`txn.edges.TXN_N_FLOOR`, `ServiceLimits.max_txns="
        f"{lim.max_txns}` |",
        f"| mesh shard axis D | pow2 {L['mesh_D'][0]}.."
        f"{L['mesh_D'][1]} | `service.sharding.MAX_SHARDS` |",
        f"| shrink kept-op buckets | pow2 {L['shrink_bucket'][0]}.."
        f"{L['shrink_bucket'][1]} | `shrink.verdicts.MIN_BUCKET` |",
        f"| shrink batch B | pow2 {L['shrink_B'][0]}.."
        f"{L['shrink_B'][1]} | `shrink.verdicts.MAX_BATCH` |",
        f"| memo table dims | pow2 {L['memo_dim'][0]}.."
        f"{L['memo_dim'][1]} | `next_pow2` at every dispatch path |",
        f"| mxu table caps | pow2 1..{L['mxu_table'][0]} x pow2 1.."
        f"{L['mxu_table'][1]} | `checker.mxu.S_CAP/T_CAP` |",
        f"| mxu frontier F | {list(L['mxu_F'])} | "
        "`checker.mxu.CAPACITIES` |",
        f"| mxu chunk | pow2 {L['mxu_chunk'][0]}..{L['mxu_chunk'][1]}"
        " | `checker.mxu.CHUNK` |",
        f"| mxu P | {L['mxu_P'][0]}..{L['mxu_P'][1]} | "
        "`checker.mxu.MIN_P/MAX_P` |",
        f"| mxu key words | {list(L['mxu_words'])} | "
        "`PackPlan.n_words` over the table caps x P |",
        f"| stream delta_pad | {list(L['stream_delta'])} | "
        "`stream.engine.DELTA_PADS` |",
        f"| stream frontier F | {list(L['stream_F'])} | "
        "`stream.engine.STREAM_CAPACITIES` |",
        f"| stream P | even {L['stream_P'][0]}..{L['stream_P'][-1]} |"
        " session slot width |",
        f"| stream session B | {list(L['stream_B'])} | "
        "`stream.engine.MEGABATCH_LANES` |",
        f"| wl batch B | {list(L['wl_batch'])} | "
        "`checker.wl.batch.WL_BATCH` |",
        f"| wl reads | {list(L['wl_reads'])} | "
        "`checker.wl.batch.WL_READS` |",
        f"| wl accounts | {list(L['wl_accounts'])} | "
        "`checker.wl.batch.WL_ACCOUNTS` |",
        f"| wl snapshots | {list(L['wl_snaps'])} | "
        "`checker.wl.batch.WL_SNAPS` |",
        f"| wl elements | {list(L['wl_elems'])} | "
        "`checker.wl.batch.WL_ELEMS` |",
        f"| wl nodes | {list(L['wl_nodes'])} | "
        "`checker.wl.batch.WL_NODES` |",
        f"| wl values | {list(L['wl_values'])} | "
        "`checker.wl.batch.WL_VALUES` |",
        f"| wl delta rows | {list(L['wl_delta'])} | "
        "`checker.wl.batch.WL_DELTA_PADS` |",
        f"| kernel P / K / key words | {list(L['kernel_P'])} / "
        f"{list(L['kernel_K'])} / {list(L['kernel_words'])} | "
        "`seg_kernel.spec_for` over the fuzz buckets |",
        f"| pair-sort row N | pow2 {L['pair_sort_N'][0]}.."
        f"{L['pair_sort_N'][1]} | `next_pow2(F (P + 1))`, F "
        f"{KEYS_F[0]}..{KEYS_F[1]}, P {KEYS_P[0]}..{KEYS_P[1]} |",
        "",
        "## Kernel sites",
        "",
    ]
    for site in inv.sites:
        out += [f"### {site.key}", "",
                f"- kernel: `{site.kernel}`",
                f"- {site.note}",
                f"- layouts: {site.axes_doc}",
                f"- variants: {len(site.layouts)}", ""]
    out += [
        "## Kernel spec tiers",
        "",
        f"{len(L['specs'])} distinct `SegKernelSpec` tiers are reachable "
        "from the production bucket ladder x P(1..15) x K(1..8) — the "
        "per-tier Hopper budget is the `--budget-table` artifact.",
        "",
        "## Witnesses (computed through spec_for)",
        "",
        "| site | witness | (kernel, layout) |",
        "|---|---|---|",
    ]
    for key, desc, v in witness_table():
        out.append(f"| {key} | {desc} | {v} |")
    out.append("")
    return "\n".join(out)


# --- the unbucketed-dispatch-site AST rule ----------------------------------

#: sinks: callee name -> shape-carrying argument spec. The batch /
#: serving surface of the port, under the JAX package's names where the
#: port kept them; the single-history driver passes exact sizes on
#: purpose (``spec_for`` sizes the kernel from them at run time)
SHAPE_SINKS: Dict[str, dict] = {
    "check_batch": {"kwargs": ("s_pad", "k_pad", "n_states_pad",
                               "n_transitions_pad", "p_eff_pad")},
    "check_batch_async": {"kwargs": ("s_pad", "k_pad",
                                     "n_states_pad",
                                     "n_transitions_pad",
                                     "p_eff_pad")},
    "segment_batch": {"kwargs": ("s_pad", "k_pad")},
    "pack_batch": {"kwargs": ("n_pad",)},
    "make_segments": {"kwargs": ("s_pad", "k_pad")},
    "pad_succ": {"kwargs": ("s_pad", "t_pad"), "pos": (1, 2)},
    "check_device_keys": {"kwargs": ("n_states", "n_transitions")},
    "check_device_flat": {"kwargs": ("n_states", "n_transitions")},
    "check_device_seg_batch": {"kwargs": ("n_states",
                                          "n_transitions")},
    "check_device_mxu_batch": {"kwargs": ("n_states",
                                          "n_transitions")},
    "check_device_batch": {"kwargs": ("n_states", "n_transitions")},
    "check_device_keys_sharded": {"kwargs": ("B", "n_states",
                                             "n_transitions")},
    "stream_dispatch": {"kwargs": ("n_states", "n_transitions")},
    "stream_stage": {"kwargs": ("n_states", "n_transitions")},
    "stream_dispatch_sharded": {"kwargs": ("n_states",
                                           "n_transitions")},
    "stream_stage_sharded": {"kwargs": ("n_states",
                                        "n_transitions")},
    "check_sharded": {"kwargs": ("n_states", "n_transitions")},
    "stream_delta_chunk": {"kwargs": ("n_states", "n_transitions")},
    "stream_delta_megabatch": {"kwargs": ("n_states",
                                          "n_transitions")},
    "check_device_mxu_megabatch": {"kwargs": ("n_states",
                                              "n_transitions")},
    "wl_bank_check": {"kwargs": ("n_reads", "n_accounts",
                                 "n_snaps")},
    "wl_bank_delta": {"kwargs": ("n_reads", "n_accounts",
                                 "n_snaps")},
    "wl_bank_delta_mb": {"kwargs": ("n_reads", "n_accounts",
                                    "n_snaps")},
    "wl_sets_check": {"kwargs": ("n_elems",)},
    "wl_sets_delta": {"kwargs": ("n_elems",)},
    "wl_sets_delta_mb": {"kwargs": ("n_elems",)},
    "wl_dirty_check": {"kwargs": ("n_reads", "n_nodes",
                                  "n_values")},
    "check_wl_batch": {"kwargs": ("b_pad",)},
    "stage_wl_batch": {"kwargs": ("b_pad",)},
}

#: callables that PRODUCE bucketed values
SANCTIONERS = {"next_pow2", "_next_pow2", "bucket_of", "padded",
               "pad_sizes"}

#: attribute reads that are raw per-history counts (memo tables)
RAW_ATTRS = {"n_states", "n_transitions"}

#: attribute reads that are ladder-derived by construction
#: (service Bucket / TxnBucket fields)
BUCKETED_ATTRS = {"S", "K", "P", "P_eff", "n_pad", "N"}

_MAX_DEPTH = 5

BUCKETED, RAW, UNKNOWN = 0, 1, 2


@dataclass
class _FileInfo:
    path: str
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, ast.AST] = field(default_factory=dict)
    consts: Dict[str, int] = field(default_factory=dict)


class _Graph:
    """Cross-file call graph over the scanned set: function defs by
    name (chased only when unambiguous or same-file) and call sites by
    callee name."""

    def __init__(self, infos: List[_FileInfo]):
        self.infos = infos
        self.defs: Dict[str, List[Tuple[_FileInfo, ast.AST]]] = {}
        # callee name -> [(info, call node, enclosing funcdef | None)]
        self.calls: Dict[str, List[tuple]] = {}
        for info in infos:
            self._index(info)

    @staticmethod
    def _callee(call: ast.Call) -> str:
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return ""

    def _index(self, info: _FileInfo) -> None:
        from .kernel_budget import _module_consts

        info.consts = _module_consts(info.tree)

        def walk(node, fn):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                info.funcs.setdefault(node.name, node)
                self.defs.setdefault(node.name, []).append((info, node))
                fn = node
            if isinstance(node, ast.Call):
                name = self._callee(node)
                if name:
                    self.calls.setdefault(name, []).append(
                        (info, node, fn))
            for child in ast.iter_child_nodes(node):
                walk(child, fn)

        walk(info.tree, None)

    def def_of(self, name: str,
               prefer: _FileInfo) -> Optional[Tuple[_FileInfo, ast.AST]]:
        cands = self.defs.get(name, [])
        same = [c for c in cands if c[0] is prefer]
        if same:
            return same[0]
        if len(cands) == 1:          # unambiguous across the repo
            return cands[0]
        return None                  # ambiguous: stay silent


def _classify(expr: ast.AST, info: _FileInfo,
              fn: Optional[ast.AST], graph: _Graph,
              depth: int, visited: set):
    """(verdict, detail, anchor_line) for a shape-valued expression.
    RAW means PROVABLY unbucketed; UNKNOWN means out of AST reach
    (silent — the runtime guard is the backstop)."""
    if depth > _MAX_DEPTH:
        return UNKNOWN, "", 0
    if isinstance(expr, ast.Constant):
        v = expr.value
        if v is None:
            return BUCKETED, "", 0       # no-floor sentinel
        if isinstance(v, bool) or not isinstance(v, int):
            return UNKNOWN, "", 0
        if v == 0 or _is_pow2(v):
            return BUCKETED, "", 0       # 0 = no-floor sentinel
        return RAW, f"literal {v} is not a power of two", expr.lineno
    if isinstance(expr, ast.Call):
        name = _Graph._callee(expr)
        if name in SANCTIONERS:
            return BUCKETED, "", 0
        if name == "len":
            return RAW, "a raw len(...) reaches the dispatch site", \
                expr.lineno
        if name in ("min", "max"):
            verdicts = [_classify(a, info, fn, graph, depth + 1,
                                  visited) for a in expr.args]
            if any(v[0] == RAW for v in verdicts):
                return next(v for v in verdicts if v[0] == RAW)
            if verdicts and all(v[0] == BUCKETED for v in verdicts):
                return BUCKETED, "", 0
        return UNKNOWN, "", 0
    if isinstance(expr, ast.Attribute):
        if expr.attr in RAW_ATTRS:
            return RAW, f"raw memo count .{expr.attr} reaches the " \
                "dispatch site (one layout per distinct history " \
                "shape)", expr.lineno
        if expr.attr in BUCKETED_ATTRS:
            return BUCKETED, "", 0
        return UNKNOWN, "", 0
    if isinstance(expr, ast.Subscript):
        base = expr.value
        if isinstance(base, ast.Attribute) and base.attr == "shape":
            return RAW, "raw .shape[...] reaches the dispatch site " \
                "unbucketed", expr.lineno
        return UNKNOWN, "", 0
    if isinstance(expr, (ast.BoolOp, ast.IfExp)):
        parts = (expr.values if isinstance(expr, ast.BoolOp)
                 else [expr.body, expr.orelse])
        verdicts = [_classify(p, info, fn, graph, depth + 1, visited)
                    for p in parts]
        for v in verdicts:
            if v[0] == RAW:
                return v
        if verdicts and all(v[0] == BUCKETED for v in verdicts):
            return BUCKETED, "", 0
        return UNKNOWN, "", 0
    if isinstance(expr, ast.BinOp):
        for side in (expr.left, expr.right):
            v = _classify(side, info, fn, graph, depth + 1, visited)
            if v[0] == RAW:
                return v
        return UNKNOWN, "", 0
    if isinstance(expr, ast.Name):
        return _classify_name(expr.id, getattr(expr, "lineno", 0),
                              info, fn, graph, depth, visited)
    return UNKNOWN, "", 0


def _classify_name(name: str, use_line: int, info: _FileInfo,
                   fn: Optional[ast.AST], graph: _Graph, depth: int,
                   visited: set):
    # the LAST local assignment dominating the use site wins
    if fn is not None:
        best = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name \
                    and node.lineno < use_line \
                    and (best is None or node.lineno > best.lineno):
                best = node
        if best is not None:
            return _classify(best.value, info, fn, graph,
                             depth + 1, visited)
        # a parameter: chase every call site of the enclosing function
        args = getattr(fn, "args", None)
        if args is not None:
            names = [a.arg for a in args.args]
            if name in names:
                return _chase_param(fn, name, names.index(name),
                                    graph, depth, visited)
    if name in info.consts:
        v = info.consts[name]
        if v == 0 or _is_pow2(v):
            return BUCKETED, "", 0
        return RAW, f"module constant {name}={v} is not a power of " \
            "two", 0
    return UNKNOWN, "", 0


def _chase_param(fn: ast.AST, param: str, pos: int, graph: _Graph,
                 depth: int, visited: set):
    """Interprocedural step: classify the argument bound to ``param``
    at every call site of ``fn``. A single provably-raw call site makes
    the parameter RAW (anchored at that call site)."""
    key = (id(fn), param)
    if key in visited or depth > _MAX_DEPTH:
        return UNKNOWN, "", 0
    visited = visited | {key}
    sites = graph.calls.get(fn.name, [])
    if not sites:
        return UNKNOWN, "", 0
    defaults = getattr(fn, "args", None)
    n_pos = len(defaults.args) if defaults is not None else 0
    is_method = (defaults is not None and defaults.args
                 and defaults.args[0].arg in ("self", "cls"))
    all_bucketed = True
    for cinfo, call, cfn in sites:
        arg_expr = None
        for kw in call.keywords:
            if kw.arg == param:
                arg_expr = kw.value
        # positional mapping: methods called through an attribute drop
        # the self slot; other method call forms make no claim
        cpos = pos
        if is_method:
            cpos = pos - 1 if isinstance(call.func, ast.Attribute) \
                else -1
        if arg_expr is None and 0 <= cpos < len(call.args) \
                and not any(isinstance(a, ast.Starred)
                            for a in call.args[:cpos + 1]) \
                and pos < n_pos:
            arg_expr = call.args[cpos]
        if arg_expr is None:
            all_bucketed = False     # default value / splat: no claim
            continue
        v, detail, anchor = _classify(arg_expr, cinfo, cfn, graph,
                                      depth + 1, visited)
        if v == RAW:
            return RAW, f"{detail} (via {fn.name}({param}=...) at " \
                f"{os.path.basename(cinfo.path)}:" \
                f"{anchor or call.lineno})", anchor or call.lineno
        if v != BUCKETED:
            all_bucketed = False
    if all_bucketed:
        return BUCKETED, "", 0
    return UNKNOWN, "", 0


def _file_infos(paths: Sequence[str]) -> List[_FileInfo]:
    infos: List[_FileInfo] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        try:
            with open(p, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=p)
        except (OSError, SyntaxError):
            continue                 # lint owns syntax errors
        infos.append(_FileInfo(path=p, tree=tree,
                               lines=src.splitlines()))
    return infos


def scan_files(paths: Sequence[str], *,
               apply_suppressions: bool = True) -> List[Finding]:
    """The ``unbucketed-dispatch-site`` rule over a file set (the call
    graph is built over exactly these files)."""
    infos = _file_infos(paths)
    graph = _Graph(infos)
    out: List[Finding] = []
    for info in infos:
        for name, spec in SHAPE_SINKS.items():
            for cinfo, call, cfn in graph.calls.get(name, []):
                if cinfo is not info:
                    continue
                exprs: List[Tuple[str, ast.AST]] = []
                for kw in call.keywords:
                    if kw.arg in spec.get("kwargs", ()):
                        exprs.append((kw.arg, kw.value))
                for pos in spec.get("pos", ()):
                    if pos < len(call.args) and not any(
                            isinstance(a, ast.Starred)
                            for a in call.args[:pos + 1]):
                        exprs.append((f"arg{pos}", call.args[pos]))
                for argname, expr in exprs:
                    v, detail, _ = _classify(
                        expr, info, cfn, graph, 0, set())
                    if v != RAW:
                        continue
                    out.append(Finding(
                        "unbucketed-dispatch-site", info.path,
                        call.lineno,
                        f"{name}({argname}=...): {detail} — every "
                        "shape on the serving surface must come from a "
                        "declared ladder (next_pow2 / service bucket / "
                        "kernel spec); an unbucketed shape launches a "
                        "kernel layout per distinct history"))
    if not apply_suppressions:
        return out
    # suppressions apply at the sink line
    by_path = {info.path: info.lines for info in infos}
    return [f for f in out
            if not suppressed(by_path.get(f.path, ()), f.line,
                              f.rule)]


# --- the runtime half, on the card ------------------------------------------

#: a pair-sort row the keys engine never sorts: under the ladder's
#: floor (its smallest row is F (P + 1) >= 24 pairs, padded to 32)
UNBUCKETED_PAIR_SORT_N = 16


def mixed_workload(device="cuda") -> dict:
    """The runtime half of the prover: a mixed workload through both
    kernels under :func:`~..utils.compile_guard.guard` — ``check_batch``
    on two shape buckets (the stream kernel), a batch whose lanes
    overflow the kernel's 128 configs through ``engine="keys"`` (the
    pair sort), a ``Shrinker`` for up to 32 steps, ``closure_diag`` and
    ``closure_diag_batch`` at two N buckets, and one single-history
    check (the carry mode) — whose launched variants must stay inside
    :meth:`Inventory.variants`; then a deliberately unbucketed
    pair-sort row, which the guard must catch.

    Returns ``{"variants", "counters", "shrink_steps", "control"}``. It
    raises :class:`~..utils.compile_guard.CompileSurfaceError` on an
    offender, :class:`AssertionError` on a wrong verdict (every history
    is VALID; the wide lanes overflow the kernel's 128 configs and the
    keys engine decides them at F = 1024), and raises without a card or
    ``nvcc`` (``device="cpu"`` runs the plain versions, which launch
    nothing)."""
    import random

    import numpy as np
    import torch

    from ..checker import analysis
    from ..checker.batch import check_batch, pack_batch
    from ..checker.pair_sort import pair_sort
    from ..models.model import cas_register
    from ..ops import op as O
    from ..ops.synth import register_history
    from ..shrink import Shrinker
    from ..txn import closure_torch as TCL
    from ..utils import compile_guard as CG
    from ..utils import resolve_device

    dev = resolve_device(device)
    inv = static_inventory()
    rng = random.Random(7)
    with CG.guard() as g:
        # two shape buckets through the stream kernel
        for n_ev, B in ((24, 4), (48, 8)):
            hs = [register_history(rng, n_procs=3, n_events=n_ev,
                                   p_info=0.0) for _ in range(B)]
            info: dict = {}
            status, _, _ = check_batch(pack_batch(hs, cas_register()),
                                       F=64, engine="stream", info=info,
                                       device=dev)
            if not (np.asarray(status) == 0).all():
                raise AssertionError(f"stream bucket ({n_ev}, {B}): "
                                     f"statuses {status}")
        # lanes whose frontier passes 128 configs, through the keys
        # engine and its pair sort
        wide = pack_batch([register_history(rng, n_procs=8,
                                            n_events=160, values=8,
                                            p_info=0.0, max_pending=8)
                           for _ in range(4)], cas_register())
        status, _, _ = check_batch(wide, F=128, engine="stream",
                                   device=dev)
        if not (np.asarray(status) == 2).any():
            raise AssertionError(f"no wide lane overflowed the kernel's "
                                 f"128 configs: {status}")
        status, _, _ = check_batch(wide, F=1024, engine="keys",
                                   device=dev)
        if not (np.asarray(status) == 0).all():
            raise AssertionError(f"keys engine at F=1024: {status}")
        # shrink: pow2 kept-op buckets through check_batch
        seed = [O.invoke(0, "write", 1), O.ok(0, "write", 1),
                O.invoke(1, "write", 2), O.ok(1, "write", 2),
                O.invoke(2, "read", None), O.Op(2, "ok", "read", 1)]
        for _ in range(8):
            seed += [O.invoke(3, "write", 3), O.ok(3, "write", 3)]
        job = Shrinker(seed, "cas-register", F=64, device=dev)
        steps = 0
        while not job.step() and steps < 32:
            steps += 1
        if job.error is not None:
            raise AssertionError(f"shrink failed: {job.error}")
        # txn closure: two N buckets, single and batched
        TCL.closure_diag(np.zeros((4, 16, 16), bool), device=dev)
        TCL.closure_diag_batch(np.zeros((2, 4, 32, 32), bool),
                               device=dev)
        # one single history through the carry mode
        one = register_history(rng, n_procs=3, n_events=200,
                               p_info=0.0)
        a = analysis(cas_register(), one, backend="device", device=dev)
        if a.valid is not True:
            raise AssertionError(f"single history: {a.valid}")
    variants = g.variants()
    g.assert_closed(inv.variants())
    control = None
    if dev.type == "cuda":
        with CG.guard() as g2:
            n = UNBUCKETED_PAIR_SORT_N
            pair_sort(torch.zeros((1, n), dtype=torch.int32, device=dev),
                      torch.arange(n, dtype=torch.int32, device=dev)
                      .flip(0)[None].contiguous())
        try:
            g2.assert_closed(inv.variants())
        except CG.CompileSurfaceError as e:
            control = str(e)
        else:
            raise AssertionError(
                f"a pair_sort row of {UNBUCKETED_PAIR_SORT_N} pairs, "
                "outside the declared ladder, was not caught")
    return {"variants": {f"{k} {lay!r}": n
                         for (k, lay), n in sorted(variants.items(),
                                                   key=repr)},
            "counters": g.counters(), "shrink_steps": steps,
            "control": control}


__all__ = ["Inventory", "SHAPE_SINKS", "Site", "check_witnesses",
           "mixed_workload", "render_programs", "scan_files",
           "static_inventory", "witness_table"]


from . import Pass, filter_suppressed, register_pass  # noqa: E402


def _repo_stage(ctx):
    # raw once: the stage filters suppressions itself and deposits the
    # raw findings for the stale-suppression audit (one call-graph
    # build per run)
    raw = scan_files(ctx["prod"], apply_suppressions=False)
    ctx["raw"]["compile-surface"] = raw
    out = filter_suppressed(raw)
    if ctx["trace"]:
        out += check_witnesses()
    return out


register_pass(Pass(
    name="compile-surface",
    scan_paths=scan_files,
    raw_paths=lambda paths: scan_files(paths,
                                       apply_suppressions=False),
    repo_stage=_repo_stage,
))
