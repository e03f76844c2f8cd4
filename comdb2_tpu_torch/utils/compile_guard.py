"""Runtime kernel-surface guard.

The counterpart of the JAX package's ``utils/compile_guard.py``. What
compiles in the port is not an XLA lowering per shape: each CUDA source
is built once by ``nvcc`` into a library (``kernels/build.py``), and
every launch passes its layout at run time. So the surface to watch is
the number of builds, the launches, and the (kernel, layout) variants
that were launched:

- ``KERNEL_BUILDS``: one per ``nvcc`` build that :mod:`..kernels.build`
  ran in this process (a library already built on disk costs none);
- ``LAUNCHES[name]``: one per ``seg_search`` (carry mode),
  ``seg_search_stream`` (stream mode) and ``pair_sort`` launch, counted
  by the wrappers where they launch on the card and nowhere else (the
  plain versions on CPU tensors count nothing);
- ``VARIANTS[(kernel, layout)]``: launches per variant — the
  segment-search layout is ``(P, K, n_words)`` of its
  :class:`SegKernelSpec`, the pair sort's the row length;
- :func:`card_ms`: the card's milliseconds in those launches, from CUDA
  events the wrappers record around each launch once
  :func:`time_launches` is on (the daemon turns it on).

:class:`CompileGuard` reads them over a window, and
:meth:`CompileGuard.assert_closed` raises :class:`CompileSurfaceError`
when a variant outside a declared set was launched in it. The service
scrapes the counters where the JAX package's scrapes its lowering and
Mosaic-build counters.

Usage::

    from comdb2_tpu_torch.utils import compile_guard
    with compile_guard.guard() as g:
        ...                         # any checker / service / shrink work
    g.assert_closed({("seg_search_stream", None)})

A declared pair whose layout is ``None`` admits every layout of that
kernel.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, List, Tuple

#: ``nvcc`` builds run by this process
KERNEL_BUILDS = 0

#: launches on the card, by kernel
LAUNCHES: Dict[str, int] = {"seg_search": 0, "seg_search_stream": 0,
                            "pair_sort": 0}

#: launches on the card, by (kernel, layout)
VARIANTS: Dict[Tuple[str, object], int] = {}

#: the card's milliseconds in the timed launches read so far
CARD_MS = 0.0
_TIMING = False
_OPEN: list = []        # (start, end) events of launches not yet read


def note_build() -> None:
    """One ``nvcc`` build finished (``kernels.build``)."""
    global KERNEL_BUILDS
    KERNEL_BUILDS += 1


def time_launches(on: bool = True) -> None:
    """Time every launch from now on: two CUDA event records around
    each, read by :func:`card_ms`."""
    global _TIMING
    _TIMING = on


def launch_begins(stream):
    """The start event of a timed launch on ``stream``, recorded just
    before it (None while timing is off)."""
    if not _TIMING:
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def note_launch(kernel: str, layout, begun=None, stream=None) -> None:
    """One launch of ``kernel`` at ``layout`` (the wrappers, after the
    launch returned without error); ``begun`` is its start event from
    :func:`launch_begins`, and its end event is recorded on ``stream``
    here."""
    LAUNCHES[kernel] += 1
    VARIANTS[(kernel, layout)] = VARIANTS.get((kernel, layout), 0) + 1
    if begun is not None:
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        _OPEN.append((begun, end))
        if len(_OPEN) > 256:          # read what has finished, so the
            card_ms()                 # list holds the launches in flight


def card_ms() -> float:
    """:data:`CARD_MS` after adding every timed launch that has
    finished; polls the events, never waits."""
    global CARD_MS
    still = []
    for start, end in _OPEN:
        if end.query():
            CARD_MS += start.elapsed_time(end)
        else:
            still.append((start, end))
    _OPEN[:] = still
    return CARD_MS


class CompileSurfaceError(AssertionError):
    """A launched variant is outside the declared set."""


class CompileGuard:
    """The counters over one window, from its creation."""

    def __init__(self) -> None:
        self._builds0 = KERNEL_BUILDS
        self._launches0 = dict(LAUNCHES)
        self._variants0 = dict(VARIANTS)

    def counters(self) -> dict:
        """Builds and launches inside the window."""
        return {"kernel_builds": KERNEL_BUILDS - self._builds0,
                "launches": {k: n - self._launches0.get(k, 0)
                             for k, n in LAUNCHES.items()}}

    def variants(self) -> Dict[Tuple[str, object], int]:
        """Launches per (kernel, layout) inside the window."""
        out = {v: n - self._variants0.get(v, 0) for v, n in VARIANTS.items()}
        return {v: n for v, n in out.items() if n}

    def offenders(self, declared: Iterable) -> List[Tuple[str, object]]:
        """Window variants outside ``declared`` (pairs of kernel and
        layout; a ``None`` layout admits every layout)."""
        decl = set(declared)
        wild = {k for k, lay in decl if lay is None}
        return sorted((v for v in self.variants()
                       if v not in decl and v[0] not in wild), key=repr)

    def assert_closed(self, declared: Iterable) -> None:
        off = self.offenders(declared)
        if off:
            raise CompileSurfaceError(
                "launched kernel variants outside the declared set:\n  "
                + "\n  ".join(f"{k} {lay}" for k, lay in off))


@contextmanager
def guard():
    """``with compile_guard.guard() as g: ...`` — the counters over the
    block (read ``g`` inside it or after it)."""
    yield CompileGuard()


__all__ = ["CompileGuard", "CompileSurfaceError", "KERNEL_BUILDS",
           "LAUNCHES", "VARIANTS", "card_ms", "guard", "launch_begins",
           "note_build", "note_launch", "time_launches"]
