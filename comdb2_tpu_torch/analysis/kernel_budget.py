"""The Hopper budget of the port's hand-written kernels — the
counterpart of the JAX package's ``analysis/pallas_budget.py``.

The TPU kernel's limits were Mosaic's (scalar-prefetch SMEM, SMEM per
grid step, (8, 128) blocks). The segment-search kernel's are a Hopper
CTA's (the ``hopper-kernels`` guide): at most 232,448 bytes of dynamic
shared memory after opt-in, 255 registers a thread, 65,536 an SM,
1,024 threads a CTA. Two halves:

- **Static** (CPU, no device): :func:`smem_bytes` mirrors ``static
  size_t smem_bytes`` in ``kernels/seg_search.cu`` exactly;
  :func:`production_tiers` enumerates the production bucket ladder x
  P (1..15) x K (1..8) through ``seg_kernel.spec_for``;
  :func:`check_spec` checks a tier at ``WARPS_PER_CTA`` warps and the
  largest table the tier admits (``MAX_TABLE``);
  :func:`check_production` adds the meta-gates (``spec_for`` must keep
  rejecting K = 9, P = 16 and a table over ``MAX_TABLE``);
  :func:`budget_table` renders the result. :func:`scan_file` is the
  AST half: literal ``spec_for`` / ``smem_bytes`` configurations, and
  the ``cuda-constant-mirror`` rule — every ``#define`` of a CUDA
  source that a Python module also states must agree with it (in the
  port, a wrong mirror is the failure that takes the place of a bad
  ``BlockSpec``).
- **Card** (:func:`check_built`): reads what the built libraries say —
  each tier's dynamic shared memory from the library against the
  mirror and the card's opt-in limit, the occupancy in warp-streams
  per SM, and every kernel's registers and spills. It raises on a host
  without CUDA or ``nvcc``.

Rule ids (new for Hopper): ``hopper-k-cap``, ``hopper-p-cap``,
``hopper-key-words``, ``hopper-table-budget``, ``hopper-smem-budget``,
``hopper-cta-threads``, ``cuda-constant-mirror``; on the card
``hopper-smem-mirror``, ``hopper-registers``, ``hopper-spill`` and
``hopper-occupancy``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import Finding, suppressed

#: dynamic shared memory a Hopper CTA may opt into (bytes)
SMEM_OPTIN_BYTES = 232_448
#: registers of one thread (an SM holds 65,536: the occupancy query
#: accounts for them)
REGS_PER_THREAD = 255
#: threads of one CTA
THREADS_PER_CTA = 1_024
WARP = 32
#: the least warp-streams an SM must hold at every production tier
#: (one full CTA of ``WARPS_PER_CTA`` warps)
MIN_WARP_STREAMS_PER_SM = 8

# --- the mirror of kernels/seg_search.cu's smem_bytes inputs ---------------
#: ``#define``s of ``seg_search.cu`` that :func:`smem_bytes` needs (the
#: ``cuda-constant-mirror`` rule holds them to the source)
MAX_P = 15
MAX_KEYS = 2048
WARP_KEYS = 512
RING = 16

#: the production shape-bucket ladder (the JAX package's
#: ``pallas_budget.PRODUCTION_BUCKETS``; the fuzz script uses it)
PRODUCTION_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (8, 32), (16, 64), (64, 64), (128, 64), (256, 8))

K_CAP = 8
P_CAP = 15
MAX_WORDS = 3


def _seg_kernel():
    from ..checker import seg_kernel
    return seg_kernel


def smem_bytes(spec, table_n: int, warps: int) -> int:
    """Dynamic shared memory of a CTA of ``warps`` warps at ``spec``
    over a table of ``table_n`` entries — ``smem_bytes`` of
    ``kernels/seg_search.cu``: the table (padded to 4 entries), the
    CTA's large-closure buffer (only when closures can pass
    ``WARP_KEYS``), and per warp a ``WARP_KEYS``-key buffer, the
    128-lane frontier and the double-buffered row ring, in ints."""
    lanes = _seg_kernel().LANES
    big_cap = spec.n_keys if spec.n_keys > WARP_KEYS else 0
    per_warp = (spec.n_words * (WARP_KEYS + lanes)
                + 2 * RING * (2 + 2 * spec.K))
    return 4 * ((table_n + 3) // 4 * 4 + spec.n_words * big_cap
                + warps * per_warp)


def check_config(*, K: Optional[int] = None, P: Optional[int] = None,
                 table_n: Optional[int] = None,
                 n_words: Optional[int] = None,
                 smem: Optional[int] = None,
                 warps: Optional[int] = None,
                 where: str = "<config>", path: str = "<config>",
                 line: int = 0) -> List[Finding]:
    """Budget-check one kernel configuration; any field may be left
    None (unchecked). The golden tests drive this directly."""
    out: List[Finding] = []
    if K is not None and K > K_CAP:
        out.append(Finding(
            "hopper-k-cap", path, line,
            f"{where}: K={K} exceeds the kernel's {K_CAP} invokes per "
            "segment (the row ring and the invoke loop are sized for "
            "MAX_K; spec_for must gate on it)"))
    if P is not None and P > P_CAP:
        out.append(Finding(
            "hopper-p-cap", path, line,
            f"{where}: P={P} exceeds the kernel's {P_CAP} slots (the "
            "layout's slot arrays and the large-closure buffer are "
            "sized for MAX_P)"))
    if table_n is not None and table_n > _seg_kernel().MAX_TABLE:
        out.append(Finding(
            "hopper-table-budget", path, line,
            f"{where}: a table of {table_n} entries exceeds MAX_TABLE="
            f"{_seg_kernel().MAX_TABLE} (the CTA keeps its one copy "
            "in shared memory)"))
    if n_words is not None and n_words > MAX_WORDS:
        out.append(Finding(
            "hopper-key-words", path, line,
            f"{where}: {n_words} key words exceed the kernel's "
            f"{MAX_WORDS} (one template instance per width)"))
    if smem is not None and smem > SMEM_OPTIN_BYTES:
        out.append(Finding(
            "hopper-smem-budget", path, line,
            f"{where}: {smem} bytes of dynamic shared memory per CTA "
            f"exceed the {SMEM_OPTIN_BYTES} a Hopper CTA may opt into "
            "— the launch would be refused"))
    if warps is not None and warps * WARP > THREADS_PER_CTA:
        out.append(Finding(
            "hopper-cta-threads", path, line,
            f"{where}: {warps} warps are {warps * WARP} threads, over "
            f"the {THREADS_PER_CTA} of one CTA"))
    return out


def check_spec(spec, *, where: str = "spec", path: str = "",
               table_n: Optional[int] = None,
               warps: Optional[int] = None) -> List[Finding]:
    """Budget-check one :class:`SegKernelSpec` at ``warps`` warps per
    CTA (default ``WARPS_PER_CTA``) and a table of ``table_n`` entries
    (default the largest the tier admits, ``MAX_TABLE``)."""
    SK = _seg_kernel()
    path = path or SK.__file__
    table_n = SK.MAX_TABLE if table_n is None else table_n
    warps = SK.WARPS_PER_CTA if warps is None else warps
    out = check_config(K=spec.K, P=spec.P, n_words=spec.n_words,
                       smem=smem_bytes(spec, table_n, warps),
                       warps=warps, where=where, path=path)
    if not (SK.LANES * (spec.P + 1) <= spec.n_keys <= MAX_KEYS):
        out.append(Finding(
            "hopper-smem-budget", path, 0,
            f"{where}: the large-closure buffer of {spec.n_keys} keys "
            f"is outside [128 (P + 1), MAX_KEYS={MAX_KEYS}]"))
    return out


def production_tiers() -> List[Tuple[Tuple[int, int], int, int, object]]:
    """Every distinct ``spec_for`` spec reachable from the production
    bucket ladder x P (1..15) x K (1..8), with one witness
    (bucket, P, K) each."""
    SK = _seg_kernel()
    seen: Dict[object, Tuple[Tuple[int, int], int, int]] = {}
    for bucket in PRODUCTION_BUCKETS:
        for P in range(1, P_CAP + 1):
            for K in range(1, K_CAP + 1):
                spec = SK.spec_for(bucket[0], bucket[1], P, K)
                if spec is not None and spec not in seen:
                    seen[spec] = (bucket, P, K)
    return [(b, P, K, spec) for spec, (b, P, K) in seen.items()]


def check_production() -> List[Finding]:
    """Budget-check every production tier, plus the meta-gates: the
    budgets here must still be ENFORCED by ``spec_for`` (K > 8, P > 15
    and a table over ``MAX_TABLE`` rejected) and by the CTA shape."""
    SK = _seg_kernel()
    path = SK.__file__
    out: List[Finding] = []
    for bucket, P, K, spec in production_tiers():
        out += check_spec(
            spec, where=f"spec_for({bucket[0]},{bucket[1]},P={P},K={K})")
    # the meta-gates: literal out-of-budget configs, on purpose
    if SK.spec_for(8, 32, 3, K_CAP + 1) is not None:  # analysis: ignore[hopper-k-cap]
        out += check_config(K=K_CAP + 1, where="spec_for accepts K=9",
                            path=path)
    if SK.spec_for(8, 32, P_CAP + 1, 1) is not None:  # analysis: ignore[hopper-p-cap]
        out += check_config(P=P_CAP + 1, where="spec_for accepts P=16",
                            path=path)
    big = (SK.MAX_TABLE // 64 + 1, 64)
    if SK.spec_for(big[0], big[1], 1, 1) is not None:
        out += check_config(table_n=big[0] * big[1],
                            where=f"spec_for accepts a {big} table",
                            path=path)
    out += check_config(warps=SK.WARPS_PER_CTA,
                        where="seg_kernel.WARPS_PER_CTA", path=path)
    return out


def budget_table() -> str:
    """The checked production budgets as a markdown artifact
    (computed, not read on a card)."""
    SK = _seg_kernel()
    w = SK.WARPS_PER_CTA
    rows = ["| bucket | P | K | words | closure keys | smem B at "
            f"{w} warps, {SK.MAX_TABLE}-entry table | per warp B |",
            "|---|---|---|---|---|---|---|"]
    for bucket, P, K, spec in sorted(
            production_tiers(), key=lambda t: (t[0], t[1], t[2])):
        total = smem_bytes(spec, SK.MAX_TABLE, w)
        per_warp = (smem_bytes(spec, SK.MAX_TABLE, w)
                    - smem_bytes(spec, SK.MAX_TABLE, w - 1))
        rows.append(f"| {bucket[0]}x{bucket[1]} | {P} | {K} "
                    f"| {spec.n_words} | {spec.n_keys} | {total} "
                    f"| {per_warp} |")
    head = (f"# Hopper budget table (computed; limits: dynamic shared "
            f"memory <= {SMEM_OPTIN_BYTES} B per CTA, K <= {K_CAP}, "
            f"P <= {P_CAP}, <= {MAX_WORDS} key words, table <= "
            f"{SK.MAX_TABLE})\n\n")
    return head + "\n".join(rows) + "\n"


# --- the constant mirror ----------------------------------------------------

#: (module stem part, CUDA source, {Python name: CUDA expression}):
#: a module whose stem contains the part states these ``#define``s
MIRRORS: Tuple[Tuple[str, str, Dict[str, str]], ...] = (
    ("seg_kernel", "seg_search.cu",
     {"LANES": "LANES", "F": "F_CAP", "WARPS_PER_CTA": "MAX_WARPS",
      "MAX_K": "MAX_K", "MAX_TABLE": "MAX_TABLE"}),
    ("kernel_budget", "seg_search.cu",
     {"MAX_P": "MAX_P", "MAX_KEYS": "MAX_KEYS",
      "WARP_KEYS": "WARP_KEYS", "RING": "RING"}),
    ("pair_sort", "pair_sort.cu", {"SMEM_N": "PS_T"}),
)

_DEFINE = re.compile(r"^\s*#\s*define\s+([A-Za-z_]\w*)[ \t]+(.+?)\s*$")


def _kernel_source(name: str) -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "kernels", name)


def cuda_defines(path: str) -> Dict[str, int]:
    """Integer ``#define``s of a CUDA source (the first definition of a
    name wins: an ``#ifndef`` default is the plain build's value),
    expressions over earlier defines folded."""
    raw: Dict[str, str] = {}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            m = _DEFINE.match(line.split("//", 1)[0])
            if m and m.group(1) not in raw:
                raw[m.group(1)] = m.group(2)
    env: Dict[str, int] = {}
    for name, expr in raw.items():
        try:
            v = _fold(ast.parse(expr, mode="eval").body, env)
        except SyntaxError:
            v = None
        if v is not None:
            env[name] = v
    return env


def mirror_findings(path: str, tree: ast.Module) -> List[Finding]:
    """``cuda-constant-mirror`` over one module: each module-level
    integer it states under a mirrored name must equal the source's."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if stem.startswith("test_"):
        return []
    consts = _module_consts(tree)
    lines = {n.targets[0].id: n.lineno for n in tree.body
             if isinstance(n, ast.Assign) and len(n.targets) == 1
             and isinstance(n.targets[0], ast.Name)}
    out: List[Finding] = []
    for part, source, names in MIRRORS:
        if part not in stem:
            continue
        defines = cuda_defines(_kernel_source(source))
        for py_name, c_name in names.items():
            if py_name not in consts:
                continue
            want = defines.get(c_name)
            if want is None:
                out.append(Finding(
                    "cuda-constant-mirror", path, lines[py_name],
                    f"{py_name} mirrors {source}'s {c_name}, which the "
                    "source no longer defines"))
            elif consts[py_name] != want:
                out.append(Finding(
                    "cuda-constant-mirror", path, lines[py_name],
                    f"{py_name} = {consts[py_name]} but {source} "
                    f"defines {c_name} = {want} — the wrapper and the "
                    "kernel disagree on a shape the launch relies on"))
    return out


# --- AST scan ---------------------------------------------------------------

def _module_consts(tree: ast.Module) -> Dict[str, int]:
    env: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = _fold(node.value, env)
            if v is not None:
                env[node.targets[0].id] = v
    return env


def _fold(node: ast.AST, env: Dict[str, int]) -> Optional[int]:
    """Constant-fold ints through names and + - * // / << arithmetic
    (and parentheses)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _fold(node.left, env), _fold(node.right, env)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, (ast.FloorDiv, ast.Div)) and b != 0:
            return a // b
        if isinstance(node.op, ast.LShift):
            return a << b
    return None


def _fold_tuple(node: ast.AST,
                env: Dict[str, int]) -> Optional[Tuple[int, ...]]:
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    vals = [_fold(e, env) for e in node.elts]
    if any(v is None for v in vals):
        return None
    return tuple(vals)   # type: ignore[arg-type]


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _spec_args(node: ast.Call, env) -> Optional[Tuple[int, ...]]:
    """The folded ``(n_states, n_transitions, P, K)`` of a literal
    ``spec_for`` call (positional or keyword), entries None where they
    do not fold."""
    names = ("n_states", "n_transitions", "P", "K")
    vals: List[Optional[int]] = [None] * 4
    for i, a in enumerate(node.args[:4]):
        vals[i] = _fold(a, env)
    for kw in node.keywords:
        if kw.arg in names:
            vals[names.index(kw.arg)] = _fold(kw.value, env)
    return tuple(vals)   # type: ignore[return-value]


def scan_file(path: str, source: Optional[str] = None, *,
              apply_suppressions: bool = True) -> List[Finding]:
    """AST budget scan of one file: literal ``spec_for(ns, nt, P, K)``
    and ``smem_bytes(spec_for(...), table_n, warps)`` configurations,
    and the constant mirror."""
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []           # lint reports syntax errors
    lines = source.splitlines()
    env = _module_consts(tree)
    raw: List[Finding] = mirror_findings(path, tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "spec_for":
            ns, nt, P, K = _spec_args(node, env)
            raw += check_config(
                K=K, P=P,
                table_n=ns * nt if ns is not None and nt is not None
                else None,
                where="spec_for", path=path, line=node.lineno)
        elif name == "smem_bytes" and len(node.args) == 3 \
                and isinstance(node.args[0], ast.Call) \
                and _call_name(node.args[0]) == "spec_for":
            ns, nt, P, K = _spec_args(node.args[0], env)
            table_n, warps = (_fold(a, env) for a in node.args[1:])
            if None in (ns, nt, P, K, table_n, warps):
                continue
            spec = _seg_kernel().spec_for(ns, nt, P, K)
            if spec is None:
                continue     # the spec_for call itself is reported
            raw += check_config(
                smem=smem_bytes(spec, table_n, warps), warps=warps,
                where=f"smem_bytes(spec_for({ns},{nt},{P},{K}), "
                      f"{table_n}, {warps})", path=path,
                line=node.lineno)
    if not apply_suppressions:
        return raw
    return [f for f in raw if not suppressed(lines, f.line, f.rule)]


def scan_files(paths: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        if os.path.exists(p):
            out += scan_file(p)
    return out


# --- the card half ----------------------------------------------------------

def check_built() -> Tuple[List[Finding], dict]:
    """Read the built libraries back on the card: for every production
    tier, the dynamic shared memory the library computes (it must equal
    :func:`smem_bytes` and, with the kernel's static shared memory, fit
    the card's opt-in limit) and the warp-streams one SM holds (at
    least :data:`MIN_WARP_STREAMS_PER_SM`); for every kernel, its
    registers (at most 255 a thread) and spills (none). Returns
    ``(findings, report)``. Raises without a card, without ``nvcc``,
    or when a library fails to build or answer."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("check_built reads the built kernels on the "
                           "card: torch.cuda.is_available() is false")
    from ..checker import pair_sort as PSORT
    from ..kernels import build

    SK = _seg_kernel()
    lib = build.load("seg_search")
    ps_lib = build.load("pair_sort")
    props = torch.cuda.get_device_properties(0)
    seg_attrs = SK.kernel_attrs(lib)
    optin = seg_attrs[1]["smem_optin_bytes"]
    torch_optin = getattr(props, "shared_memory_per_block_optin", None)
    path = SK.__file__
    out: List[Finding] = []
    if torch_optin is not None and torch_optin != optin:
        raise RuntimeError(f"the card's opt-in shared memory per block "
                           f"reads {torch_optin} through torch and "
                           f"{optin} through the CUDA runtime")
    tiers = production_tiers()
    worst_bytes, worst_occ = 0, None
    for bucket, P, K, spec in tiers:
        where = f"spec_for({bucket[0]},{bucket[1]},P={P},K={K})"
        lay = build.layout(spec)
        got = lib.seg_search_smem_bytes(ctypes.byref(lay), SK.MAX_TABLE,
                                        SK.WARPS_PER_CTA)
        want = smem_bytes(spec, SK.MAX_TABLE, SK.WARPS_PER_CTA)
        static = seg_attrs[spec.n_words]["static_smem_bytes"]
        if got != want:
            out.append(Finding(
                "hopper-smem-mirror", path, 0,
                f"{where}: the library computes {got} bytes of dynamic "
                f"shared memory, the Python mirror {want}"))
        if got + static > optin:
            out.append(Finding(
                "hopper-smem-budget", path, 0,
                f"{where}: {got} + {static} bytes of shared memory per "
                f"CTA exceed the card's opt-in {optin}"))
        occ = lib.seg_search_occupancy(ctypes.byref(lay), SK.MAX_TABLE)
        if occ < MIN_WARP_STREAMS_PER_SM:
            out.append(Finding(
                "hopper-occupancy", path, 0,
                f"{where}: {occ} warp-streams per SM at the largest "
                f"table, under {MIN_WARP_STREAMS_PER_SM}"))
        worst_bytes = max(worst_bytes, got)
        worst_occ = occ if worst_occ is None else min(worst_occ, occ)
    kernels = {f"seg_search<{w}>": a for w, a in seg_attrs.items()}
    kernels.update({f"pair_sort[{k}]": a for k, a in
                    PSORT.kernel_attrs(ps_lib).items()})
    for name, a in kernels.items():
        if a["registers"] > REGS_PER_THREAD:
            out.append(Finding(
                "hopper-registers", path, 0,
                f"{name}: {a['registers']} registers a thread, over "
                f"{REGS_PER_THREAD}"))
        if a["local_bytes"]:
            out.append(Finding(
                "hopper-spill", path, 0,
                f"{name}: {a['local_bytes']} bytes of local memory a "
                "thread (spills or a stack frame)"))
    ps_bytes = ps_lib.pair_sort_smem_bytes()
    if ps_bytes > optin:
        out.append(Finding(
            "hopper-smem-budget", PSORT.__file__, 0,
            f"pair_sort: {ps_bytes} bytes of dynamic shared memory per "
            f"CTA exceed the card's opt-in {optin}"))
    report = {"card": torch.cuda.get_device_name(0),
              "tiers": len(tiers), "max_smem_bytes": worst_bytes,
              "smem_optin_bytes": optin,
              "min_warp_streams_per_sm": worst_occ,
              "pair_sort_smem_bytes": ps_bytes, "kernels": kernels}
    return out, report


from . import Pass, register_pass  # noqa: E402


def _repo_stage(ctx):
    return scan_files(ctx["files"]) + check_production()


register_pass(Pass(
    name="kernel-budget",
    scan_paths=scan_files,
    raw_file=lambda path, source: scan_file(
        path, source, apply_suppressions=False),
    repo_stage=_repo_stage,
))


__all__ = ["MIN_WARP_STREAMS_PER_SM", "PRODUCTION_BUCKETS",
           "SMEM_OPTIN_BYTES", "budget_table", "check_built",
           "check_config", "check_production", "check_spec",
           "cuda_defines", "mirror_findings", "production_tiers",
           "scan_file", "scan_files", "smem_bytes"]
