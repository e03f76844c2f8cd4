"""Device-value dataflow across the host↔device seam — the counterpart
of the JAX package's ``analysis/dataflow.py``, with torch's seam.

The serving loop's throughput rests on the ring keeping dispatch and
readback DECOUPLED: stage halves upload and launch, the bounded ring
finalizes later (on the card, ``service/core.py``'s ring polls each
dispatch's readback event and never waits on it). Two rules guard that
seam:

- ``sync-readback-in-pump`` — a blocking readback of a device value
  (``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
  ``np.asarray`` / ``np.array`` / ``float()`` / ``int()`` / ``bool()``
  of a tainted value) or a wait on the card
  (``torch.cuda.synchronize()``, ``<event>.synchronize()``) inside a
  hot-path function (``pump`` / ``submit`` / ``tick`` or any
  ``*dispatch*``-named function, plus everything they call) stalls the
  scheduler beat on the card instead of staging the next bucket.
  Readbacks belong in the deferred finalize closures the ring pops:
  nested ``def`` / ``lambda`` bodies are EXCLUDED from the caller's hot
  scope (they run at finalize time) and analyzed on their own merits.
- ``per-item-transfer`` — a host↔device transfer (``.to(<device>)``,
  ``.cuda()``, ``torch.tensor`` / ``as_tensor`` with ``device=``, or a
  tainted readback) inside a per-item ``for`` / ``while`` loop: N items
  pay N copies and N synchronisations; batch the items and ride ONE
  dispatch's upload. Comprehensions are not flagged.

Device values are tracked by an INTERPROCEDURAL taint pass reusing the
call graph of ``unbucketed-dispatch-site`` (:mod:`.compile_surface`):
producers are the port's engine entry points (``check_device*``,
``stream_dispatch*``, ``stream_delta*``, ``stream_kernel*``,
``seg_search*``, ``closure_diag*``, ``cyclic_layers_device``),
``torch.*(…, device=…)``, ``.cuda()`` and ``.to(<device>)``; taint
propagates through tuple unpack, subscripts, arithmetic and
same-function attribute stores. Ambiguous callee names stop the chase.
Tests are exempt.

Both rules are scoped to the SERVING PLANE — the port's ``service/``
and ``stream/`` (plus fixture-hook basenames). The checker / txn /
shrink engine entries are the sanctioned BLOCKING BOUNDARY: their
one-shot entries read back by contract, so the hot-path chase stops
there.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from . import Finding, suppressed
from .compile_surface import _file_infos, _FileInfo, _Graph
from .lifecycle import _callee, _chain, _direct

#: callee-name prefixes whose results are device values
PRODUCER_PREFIXES = ("check_device", "stream_dispatch", "stream_delta",
                     "stream_kernel", "seg_search", "closure_diag",
                     "cyclic_layers_device")

#: torch calls that copy host data to a device when given ``device=``
TRANSFER_BUILDERS = {"tensor", "as_tensor"}

#: hot-path roots: the scheduler beat and every dispatch stage half
HOT_NAMES = {"pump", "submit", "tick"}
HOT_PART = "dispatch"

_MAX_DEPTH = 5

#: directory parts of the serving plane (plus fixture-hook basenames)
PLANE_DIRS = {"service", "stream"}


def _is_hot(name: str) -> bool:
    return name in HOT_NAMES or HOT_PART in name


def _in_plane(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    base = parts[-1]
    return (bool(PLANE_DIRS & set(parts)) or "fixtures" in parts
            or "dispatch" in base or "transfer" in base)


def _attr_chain(call: ast.Call) -> List[str]:
    if isinstance(call.func, ast.Attribute):
        return _chain(call.func)
    return []


def _is_dtype(arg: ast.AST) -> bool:
    """``torch.int32``, ``x.dtype`` and friends: a ``.to`` that only
    converts."""
    if isinstance(arg, ast.Attribute):
        return arg.attr == "dtype" or _chain(arg)[:1] == ["torch"]
    return isinstance(arg, ast.Name) and arg.id == "dtype"


def _to_device(call: ast.Call) -> bool:
    """``<x>.to(<device>)`` or ``<x>.cuda()``."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cuda":
        return True
    if call.func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    return bool(call.args) and not _is_dtype(call.args[0])


def _device_kw(call: ast.Call) -> bool:
    return any(kw.arg == "device" for kw in call.keywords)


def _is_producer(call: ast.Call) -> bool:
    name = _callee(call)
    if any(name.startswith(p) for p in PRODUCER_PREFIXES):
        return True
    if _to_device(call):
        return True
    chain = _attr_chain(call)
    return bool(chain) and chain[0] == "torch" and _device_kw(call)


def _is_transfer(call: ast.Call) -> bool:
    """A host-to-device copy: ``.to(<device>)``, ``.cuda()``, or
    ``torch.tensor`` / ``as_tensor`` with ``device=``."""
    if _to_device(call):
        return True
    chain = _attr_chain(call)
    return (chain[:1] == ["torch"] and chain[-1] in TRANSFER_BUILDERS
            and _device_kw(call))


class _FnScan:
    """Single-function forward taint scan over the DIRECT body (nested
    def/lambda subtrees excluded — deferred closures are the sanctioned
    readback points and are scanned as their own functions). Records
    readback sinks and loop-resident transfers."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.names: set = set()
        self.attrs: set = set()
        #: (lineno, kind, detail) — kind in {"readback", "transfer"}
        self.sinks: List[Tuple[int, str, str]] = []
        body = _direct(fn)
        loop_ids: set = set()
        for node in body:
            if isinstance(node, (ast.For, ast.While)):
                for sub in self._in_loop(node):
                    loop_ids.add(id(sub))
        for node in body:
            if isinstance(node, ast.Call):
                self._sink(node, in_loop=id(node) in loop_ids)
            if isinstance(node, ast.Assign):
                self._assign(node)

    @staticmethod
    def _in_loop(loop: ast.AST):
        out = []

        def walk(n):
            for ch in ast.iter_child_nodes(n):
                if isinstance(ch, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                out.append(ch)
                walk(ch)

        walk(loop)
        return out

    def _tainted(self, expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and sub.id in self.names:
                return True
            if isinstance(sub, ast.Attribute) \
                    and ast.unparse(sub) in self.attrs:
                return True
            if isinstance(sub, ast.Call) and _is_producer(sub):
                return True
        return False

    def _mark(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._mark(el)
        elif isinstance(tgt, ast.Name):
            self.names.add(tgt.id)
        elif isinstance(tgt, ast.Attribute):
            self.attrs.add(ast.unparse(tgt))
        elif isinstance(tgt, ast.Starred):
            self._mark(tgt.value)

    def _assign(self, node: ast.Assign) -> None:
        if self._tainted(node.value):
            for tgt in node.targets:
                self._mark(tgt)

    def _sink(self, call: ast.Call, *, in_loop: bool) -> None:
        name = _callee(call)
        chain = _attr_chain(call)
        if in_loop and _is_transfer(call):
            self.sinks.append((call.lineno, "transfer",
                               ast.unparse(call.func) + "(...)"))
            return
        readback = None
        if name in ("asarray", "array") and chain \
                and chain[0] in ("np", "numpy") \
                and any(self._tainted(a) for a in call.args):
            readback = f"np.{name}(<device value>)"
        elif isinstance(call.func, ast.Name) \
                and name in ("float", "int", "bool") and call.args \
                and self._tainted(call.args[0]):
            readback = f"{name}(<device value>)"
        elif isinstance(call.func, ast.Attribute) \
                and name in ("item", "tolist", "cpu", "numpy") \
                and self._tainted(call.func.value):
            readback = f"<device value>.{name}()"
        elif isinstance(call.func, ast.Attribute) \
                and name == "synchronize":
            readback = f"{ast.unparse(call.func)}()"
        if readback is not None:
            self.sinks.append(
                (call.lineno, "transfer" if in_loop else "readback",
                 readback))


def _hot_reach(graph: _Graph) -> Dict[int, str]:
    """id(funcdef) -> hot root name, for every function reachable from
    a hot root through the direct (non-deferred) call graph."""
    reach: Dict[int, str] = {}
    queue: List[Tuple[_FileInfo, ast.AST, int, str]] = []
    for info in graph.infos:
        for node in ast.walk(info.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and _is_hot(node.name):
                queue.append((info, node, 0, node.name))
    while queue:
        info, fn, depth, root = queue.pop()
        if id(fn) in reach:
            continue
        reach[id(fn)] = root
        if depth >= _MAX_DEPTH:
            continue
        for node in _direct(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _Graph._callee(node)
            tgt = graph.def_of(name, info) if name else None
            # the chase stops at the engine boundary: checker/txn/
            # shrink entries block by contract
            if tgt is not None and id(tgt[1]) not in reach \
                    and _in_plane(tgt[0].path):
                queue.append((tgt[0], tgt[1], depth + 1, root))
    return reach


def _not_tests(paths) -> list:
    out = []
    for p in paths:
        parts = p.replace("\\", "/").split("/")
        if parts[-1].startswith("test_") \
                or ("tests" in parts and "fixtures" not in parts):
            continue
        out.append(p)
    return out


def scan_files(paths, *,
               apply_suppressions: bool = True) -> List[Finding]:
    infos = _file_infos(_not_tests(paths))
    graph = _Graph(infos)
    reach = _hot_reach(graph)
    out: List[Finding] = []
    for info in infos:
        if not _in_plane(info.path):
            continue
        for fn in ast.walk(info.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            scan = _FnScan(fn)
            hot_root = reach.get(id(fn))
            for line, kind, detail in scan.sinks:
                if kind == "readback" and hot_root is not None:
                    via = ("" if _is_hot(fn.name)
                           else f" (reached from {hot_root}())")
                    out.append(Finding(
                        "sync-readback-in-pump", info.path, line,
                        f"blocking readback {detail} in hot path "
                        f"{fn.name}(){via} — the scheduler beat stalls "
                        "on the card instead of staging the next "
                        "bucket; move the readback into the ring's "
                        "deferred finalize"))
                elif kind == "transfer":
                    out.append(Finding(
                        "per-item-transfer", info.path, line,
                        f"host<->device transfer {detail} inside a "
                        f"per-item loop in {fn.name}() — N items pay N "
                        "copies and synchronisations; batch the items "
                        "and ride ONE dispatch's upload"))
    if not apply_suppressions:
        return out
    by_path = {info.path: info.lines for info in infos}
    return [f for f in out
            if not suppressed(by_path.get(f.path, ()), f.line,
                              f.rule)]


__all__ = ["scan_files"]


from . import Pass, filter_suppressed, register_pass  # noqa: E402


def _repo_stage(ctx):
    # deposit the raw scan for the stale-suppression audit so the taint
    # pass's call graph is built once per run
    raw = scan_files(ctx["prod"], apply_suppressions=False)
    ctx["raw"]["dataflow"] = raw
    return filter_suppressed(raw)


register_pass(Pass(
    name="dataflow",
    scan_paths=scan_files,
    raw_paths=lambda paths: scan_files(paths,
                                       apply_suppressions=False),
    repo_stage=_repo_stage,
))
