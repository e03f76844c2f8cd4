"""Repo-wide static invariant checker of the port —
``python -m comdb2_tpu_torch.analysis``.

The counterpart of the JAX package's ``analysis`` package. It judges
the port's own tree under the port's names: exact dedup, the ordering
of the fleet lifecycle, the seam between the serving ring and its
readbacks, closed shape ladders, and the hand-written kernels' Hopper
budgets. Six cooperating passes:

- :mod:`.lint` — AST lint rules over the port (JAX env config after
  import, multiprocessing pools, hash-fingerprint dedup, duplicated
  closures under nested ``lax.cond``, EDN/history hygiene, per-item
  dispatch, per-op host loops, raw clocks in the dispatch pipeline,
  device builders in session checkpoints).
- :mod:`.kernel_budget` — the Hopper budget of the segment-search
  kernel: every production ``spec_for`` tier is re-derived and its
  dynamic shared memory per CTA (a Python mirror of
  ``kernels/seg_search.cu``'s ``smem_bytes``) checked against what a
  Hopper CTA may opt into; the ``cuda-constant-mirror`` rule holds
  every ``#define`` a Python wrapper also states to the source; the
  card half (:func:`.kernel_budget.check_built`) reads the built
  libraries' attributes and occupancy back.
- :mod:`.bucket_audit` — the declared bucket ladder must be closed:
  bucket literals and segment pads in the fuzz script and the driver
  come from it, and every bucket fits ``spec_for``.
- :mod:`.compile_surface` — the kernel-surface prover: the static
  inventory of (kernel, layout) variants and the declared ladders,
  rendered as ``docs/programs_torch.md``; the interprocedural
  ``unbucketed-dispatch-site`` rule; and the runtime half
  (:func:`.compile_surface.mixed_workload`), a mixed workload on the
  card under :func:`comdb2_tpu_torch.utils.compile_guard.guard`.
- :mod:`.lifecycle` — the fleet lifecycle/ordering checker
  (publish-before-ready, deregister-before-close, log-after-success,
  release-in-finally, fresh-deadline-timestamp, wait-after-kill).
- :mod:`.dataflow` — the host↔device taint pass over the serving
  plane (sync-readback-in-pump, per-item-transfer) with torch's seam.
- :func:`audit_suppressions` — the ``stale-suppression`` rule: a
  marker that no longer trips its rule is itself a finding.

Rule ids are the JAX package's wherever a rule is ported, so a finding
reads the same in both packages; rules added for Hopper have their
own ids. Every pass registers itself as a :class:`Pass`
(``register_pass``); the staged runners and the stale-suppression
audit enumerate the one registry.

Per-line suppression: append ``# analysis: ignore[rule-id]`` (or a
blanket ``# analysis: ignore``) to the flagged line. Each rule's
provenance in the port is documented in ``docs/static_analysis_torch.md``.

The static passes read source text only: they never touch a device
and never probe for one. Only :func:`.kernel_budget.check_built` and
:func:`.compile_surface.mixed_workload` need the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

#: directories (relative to the repo root) the default repo scan covers
SCAN_ROOTS = ("comdb2_tpu_torch", "scripts", "tests")

#: outside the package, the scan covers the port's own files only, by
#: basename prefix (the JAX package's analysis judges the rest)
PORT_PREFIXES = {"scripts": ("torch_",),
                 "tests": ("test_torch_", "torch_")}

#: path fragments excluded from the default scan (seeded-violation
#: fixtures live under tests/fixtures/ and MUST fail the checker when
#: passed explicitly — and must not fail the repo scan)
EXCLUDE_PARTS = ("fixtures",)


@dataclass(frozen=True)
class Finding:
    """One rule violation: ``rule path:line message``."""
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.rule} {self.path}:{self.line} {self.message}"


def repo_root() -> str:
    """The repository root (parent of the ``comdb2_tpu_torch``
    package)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


@dataclass(frozen=True)
class Pass:
    """One registered analyzer.

    - ``scan_paths(paths)`` — findings over explicit files,
      suppressions applied (the fixtures / ``--changed`` mode).
    - ``raw_file(path, source)`` — per-file RAW findings (suppression
      off) for the stale-suppression audit's marker re-scan; ``None``
      for interprocedural passes.
    - ``raw_paths(paths)`` — whole-set raw findings for passes whose
      rules need the full call graph.
    - ``repo_stage(ctx)`` — optional repo-wide override; ``ctx`` is
      ``{"root", "files", "prod", "trace", "raw"}``, where ``prod``
      excludes tests and the stage may deposit its raw findings in
      ``ctx["raw"][name]`` so the audit reuses them. Default:
      ``scan_paths(ctx["files"])``.
    """
    name: str
    scan_paths: Callable[[Sequence[str]], List["Finding"]]
    raw_file: Optional[Callable[[str, str], List["Finding"]]] = None
    raw_paths: Optional[Callable[[Sequence[str]],
                                 List["Finding"]]] = None
    repo_stage: Optional[Callable[[dict], List["Finding"]]] = None


#: registration order of the built-in passes (stage order in runs)
_PASS_ORDER = ("lint", "kernel-budget", "bucket-audit",
               "compile-surface", "lifecycle", "dataflow")

#: modules that self-register a Pass on import
_PASS_MODULES = ("lint", "kernel_budget", "bucket_audit",
                 "compile_surface", "lifecycle", "dataflow")

_REGISTRY: Dict[str, Pass] = {}


def register_pass(p: Pass) -> Pass:
    """Called by each analyzer module at import time."""
    _REGISTRY[p.name] = p
    return p


def passes() -> List[Pass]:
    """Every registered pass, in stage order (importing the built-in
    analyzer modules so they self-register)."""
    import importlib

    for m in _PASS_MODULES:
        importlib.import_module(f".{m}", __name__)
    ordered = [_REGISTRY[n] for n in _PASS_ORDER if n in _REGISTRY]
    extras = [p for n, p in _REGISTRY.items() if n not in _PASS_ORDER]
    return ordered + extras


def suppressed(source_lines: Sequence[str], lineno: int,
               rule: str) -> bool:
    """True when ``lineno`` (1-based) carries an
    ``# analysis: ignore[rule]`` or blanket ``# analysis: ignore``
    marker."""
    if not (1 <= lineno <= len(source_lines)):
        return False
    line = source_lines[lineno - 1]
    if "analysis: ignore" not in line:
        return False
    marker = line.split("analysis: ignore", 1)[1]
    if marker.startswith("["):
        inside = marker[1:marker.index("]")] if "]" in marker else ""
        return rule in {r.strip() for r in inside.split(",")}
    return True


def in_scope(rel: str) -> bool:
    """Whether a repo-relative ``.py`` path belongs to the port's scan:
    anything under the package, the port's own files under
    ``scripts/`` and ``tests/``, never a fixture."""
    parts = rel.replace("\\", "/").split("/")
    if not rel.endswith(".py") or parts[0] not in SCAN_ROOTS:
        return False
    if any(part in EXCLUDE_PARTS or part.startswith(".")
           for part in parts[:-1]):
        return False
    prefixes = PORT_PREFIXES.get(parts[0])
    return prefixes is None or parts[-1].startswith(prefixes)


def collect_files(root: Optional[str] = None) -> List[str]:
    """Every ``.py`` file of the port's scan (:func:`in_scope`)."""
    root = root or repo_root()
    out: List[str] = []
    for sub in SCAN_ROOTS:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDE_PARTS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                if in_scope(os.path.relpath(path, root)):
                    out.append(path)
    return out


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def _markers(source: str):
    """``(lineno, rules-or-None)`` per ``analysis: ignore`` marker in
    REAL comments (tokenize — marker text inside string literals is
    not a marker)."""
    import io
    import tokenize

    out = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT \
                    or "analysis: ignore" not in tok.string:
                continue
            rest = tok.string.split("analysis: ignore", 1)[1]
            if rest.startswith("["):
                inside = rest[1:rest.index("]")] if "]" in rest else ""
                rules = tuple(r.strip() for r in inside.split(",")
                              if r.strip())
            else:
                rules = None                 # blanket marker
            out.append((tok.start[0], rules))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass                                 # lint owns syntax errors
    return out


def audit_suppressions(paths: Iterable[str],
                       raw_by_pass: Optional[
                           Dict[str, List[Finding]]] = None
                       ) -> List[Finding]:
    """The ``stale-suppression`` rule: an ``# analysis: ignore[...]``
    marker on a line that no longer trips that rule is itself a
    finding. Every registered pass contributes its RAW findings
    (suppression off), so a marker is live iff some raw finding of its
    rule id lands on its line. Stale-suppression findings are not
    suppressible (a blanket marker would otherwise vouch for itself).

    ``raw_by_pass``: raw findings already computed, keyed by pass name
    (the repo-staged runner threads the interprocedural stages' own
    raw scans through, so call graphs are built once per run)."""
    all_passes = passes()
    raw_by_pass = dict(raw_by_pass or {})

    paths = [p for p in paths if os.path.exists(p)]
    raw: dict = {p: [] for p in paths}
    srcs: dict = {}
    marked: List[str] = []
    for p in paths:
        try:
            srcs[p] = _read(p)
        except OSError:
            continue
        if "analysis: ignore" in srcs[p]:
            marked.append(p)
    # only marker-bearing files can produce stale-suppression findings,
    # so only they need the raw per-file re-scans
    for p in marked:
        for ps in all_passes:
            if ps.raw_file is not None:
                raw[p] += ps.raw_file(p, srcs[p])
    if marked:
        for ps in all_passes:
            if ps.raw_file is not None:
                continue
            findings = raw_by_pass.get(ps.name)
            if findings is None and ps.raw_paths is not None:
                # the full path set: an interprocedural rule needs the
                # whole call graph even when few files carry markers
                findings = ps.raw_paths(paths)
            for f in findings or []:
                raw.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for p in marked:
        if p not in srcs:
            continue
        hits = {(f.line, f.rule) for f in raw[p]}
        lines_hit = {f.line for f in raw[p]}
        for ln, rules in _markers(srcs[p]):
            if rules is None:
                if ln not in lines_hit:
                    out.append(Finding(
                        "stale-suppression", p, ln,
                        "blanket 'analysis: ignore' on a line no "
                        "rule trips — remove the marker (stale "
                        "suppressions hide future regressions)"))
                continue
            for r in rules:
                if (ln, r) not in hits:
                    out.append(Finding(
                        "stale-suppression", p, ln,
                        f"suppression for '{r}' no longer trips on "
                        "this line — remove the marker (stale "
                        "suppressions hide future regressions)"))
    return out


def _staged(stages) -> List[tuple]:
    """Run ``(name, thunk)`` stages, timing each; returns
    ``[(name, findings, seconds), ...]``."""
    import time

    out = []
    for name, thunk in stages:
        t0 = time.monotonic()
        findings = thunk()
        out.append((name, findings, time.monotonic() - t0))
    return out


def filter_suppressed(findings: Iterable[Finding]) -> List[Finding]:
    """Drop findings whose line carries a matching
    ``# analysis: ignore`` marker (reads each flagged file once)."""
    lines_of: dict = {}
    out: List[Finding] = []
    for f in findings:
        if f.path not in lines_of:
            try:
                lines_of[f.path] = _read(f.path).splitlines()
            except OSError:
                lines_of[f.path] = []
        if not suppressed(lines_of[f.path], f.line, f.rule):
            out.append(f)
    return out


def run_paths_staged(paths: Iterable[str]) -> List[tuple]:
    """Every registered pass over explicit paths — the mode the
    seeded-violation fixtures and ``--changed`` use — as timed stages,
    plus the stale-suppression audit."""
    paths = list(paths)
    stages = [(p.name, (lambda p=p: p.scan_paths(paths)))
              for p in passes()]
    stages.append(("suppression-audit",
                   lambda: audit_suppressions(paths)))
    return _staged(stages)


def run_repo_staged(root: Optional[str] = None, *,
                    trace: bool = True) -> List[tuple]:
    """The full repo-wide run as timed stages: every registered pass (a
    pass's ``repo_stage`` widens the file scan with its repo-level
    obligations — the production budget table and the constant mirror,
    the bucket closure, the compile-surface prover's production-module
    scan and witness table) and the stale-suppression audit, which
    reuses the raw findings the stages deposited in the shared ctx.
    ``trace=False`` skips the witness table."""
    root = root or repo_root()
    files = collect_files(root)
    # the interprocedural scans cover the production surface (package
    # + scripts); tests probe odd shapes on purpose
    prod = [p for p in files
            if "tests" not in os.path.relpath(p, root).replace(
                "\\", "/").split("/")]
    ctx = {"root": root, "files": files, "prod": prod,
           "trace": trace, "raw": {}}

    stages = []
    for p in passes():
        if p.repo_stage is not None:
            stages.append((p.name, (lambda p=p: p.repo_stage(ctx))))
        else:
            stages.append((p.name,
                           (lambda p=p: p.scan_paths(files))))
    stages.append(("suppression-audit",
                   lambda: audit_suppressions(
                       files, raw_by_pass=ctx["raw"])))
    return _staged(stages)


def changed_files(ref: str = "HEAD",
                  root: Optional[str] = None) -> List[str]:
    """The ``--changed`` file set: files of the port's scan
    (:func:`in_scope`) that differ from ``ref`` per
    ``git diff --name-only``, plus untracked files. Raises
    ``RuntimeError`` when git can't resolve the ref."""
    import subprocess

    root = root or repo_root()
    names: set = set()
    for cmd in (["git", "diff", "--name-only", ref, "--"],
                ["git", "ls-files", "--others",
                 "--exclude-standard"]):
        res = subprocess.run(cmd, cwd=root, capture_output=True,
                             text=True, timeout=60)
        if res.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)}: {res.stderr.strip()}")
        names.update(ln.strip() for ln in res.stdout.splitlines()
                     if ln.strip())
    out: List[str] = []
    for name in sorted(names):
        path = os.path.join(root, name)
        if in_scope(name) and os.path.exists(path):
            out.append(path)
    return out


def run_paths(paths: Iterable[str]) -> List[Finding]:
    """Flat view of :func:`run_paths_staged`."""
    return [f for _, fs, _ in run_paths_staged(paths) for f in fs]


def run_repo(root: Optional[str] = None, *,
             trace: bool = True) -> List[Finding]:
    """Flat view of :func:`run_repo_staged`."""
    return [f for _, fs, _ in run_repo_staged(root, trace=trace)
            for f in fs]


__all__ = ["Finding", "Pass", "SCAN_ROOTS", "audit_suppressions",
           "changed_files", "collect_files", "filter_suppressed",
           "in_scope", "passes", "register_pass", "repo_root",
           "run_paths", "run_paths_staged", "run_repo",
           "run_repo_staged", "suppressed"]
