"""Span tracing — monotonic clock, context-var nesting, Perfetto export.

The counterpart of the JAX package's ``obs/trace.py``, with the same
span model and export format. A span is one named interval
on the process-wide monotonic clock, carrying an optional request id
(``rid``) and a flat ``args`` dict (bucket key, byte counts, batch
width ...). Nesting is implicit: entering a span makes it the parent
of every span opened inside its ``with`` block (context-var, so
nested engine calls correlate without explicit plumbing); the request id propagates the same way via
:func:`request`.

Off the hot path by construction: when tracing is disabled —
the default — :func:`span` returns a shared no-op context manager
after ONE module-flag check, :func:`record` returns immediately, and
the :func:`traced` decorator calls straight through. Enabled spans
cost two clock reads and a deque append; the instrumented call sites
are per-dispatch/per-request, never per-op.

While enabled, the collector's pauses are spans too: :func:`enable`
installs one ``gc.callbacks`` entry, which records each collection as
``gc.young`` (generations 0 and 1) or ``gc.full`` (generation 2), with
``generation`` and ``collected`` as args, nested under whatever span
was open when it ran; :func:`disable` removes it.

:func:`monotonic` is the one clock of the dispatch pipeline: every stage
duration and the device-time attribution must come off the same
monotonic timebase or the per-request stage sums stop tiling the
measured wall time.

Export (:func:`export_chrome`) is the Chrome trace-event JSON format
(``{"traceEvents": [{"ph": "X", "ts": µs, "dur": µs, ...}]}``) —
loadable in Perfetto / ``chrome://tracing`` unmodified.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import time as _time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

#: THE pipeline clock: every stage timestamp — host pack, device,
#: finalize — and every span share one timebase.
monotonic = _time.monotonic

#: retained-span cap: a long-running process must not grow without
#: bound; the deque drops oldest, ``dropped_spans()`` counts.
DEFAULT_MAX_SPANS = 200_000

_ENABLED = False
_spans: deque = deque(maxlen=DEFAULT_MAX_SPANS)
_dropped = 0

_rid_var: ContextVar = ContextVar("comdb2_tpu_torch_obs_rid", default=None)
_parent_var: ContextVar = ContextVar("comdb2_tpu_torch_obs_span",
                                     default=None)


class Span:
    """One named monotonic-clock interval (see module docstring).
    Context manager; finished spans land in the module buffer."""

    __slots__ = ("name", "t0", "t1", "rid", "args", "parent", "_token")

    def __init__(self, name: str, args: Optional[dict] = None,
                 rid=None):
        self.name = name
        self.args = args if args is not None else {}
        self.rid = rid if rid is not None else _rid_var.get()
        self.parent = _parent_var.get()
        self.t0 = monotonic()
        self.t1: Optional[float] = None
        self._token = None

    def set(self, **attrs) -> "Span":
        """Attach attributes after the fact (byte counts etc.)."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._token = _parent_var.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _parent_var.reset(self._token)
            self._token = None
        self.t1 = monotonic()
        _append(self)
        return False


class _NoopSpan:
    """The disabled-mode singleton: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


def _append(s: Span) -> None:
    global _dropped
    if len(_spans) == _spans.maxlen:
        _dropped += 1
    _spans.append(s)


# -- the API call sites use -------------------------------------------


def span(name: str, *, rid=None, **attrs):
    """Open one span. Disabled mode returns the shared no-op after a
    single flag check — safe at dispatch-level call sites."""
    if not _ENABLED:
        return _NOOP
    return Span(name, attrs, rid=rid)


def record(name: str, t0: float, t1: float, *, rid=None,
           **attrs) -> None:
    """Emit an already-measured interval as a finished span — the
    retroactive form for intervals whose endpoints were captured
    before the span could be opened."""
    if not _ENABLED:
        return
    s = Span(name, attrs, rid=rid)
    s.t0 = t0
    s.t1 = t1
    _append(s)


def traced(name: str):
    """Decorator form of :func:`span` for whole functions (the checker
    and txn pipeline stages)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _ENABLED:
                return fn(*a, **kw)
            with Span(name):
                return fn(*a, **kw)
        return wrapper
    return deco


@contextmanager
def request(rid):
    """Set the request-id correlation for every span opened inside."""
    token = _rid_var.set(rid)
    try:
        yield
    finally:
        _rid_var.reset(token)


# -- lifecycle ---------------------------------------------------------


_gc_t0: Optional[float] = None


def _on_gc(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` entry: one span per collection. Collections
    never overlap (the interpreter runs one at a time), so one start
    time serves every thread."""
    global _gc_t0
    if phase == "start":
        _gc_t0 = monotonic()
    elif _gc_t0 is not None:
        gen = info["generation"]
        record("gc.full" if gen == 2 else "gc.young", _gc_t0, monotonic(),
               generation=gen, collected=info["collected"])
        _gc_t0 = None


def enable(max_spans: int = DEFAULT_MAX_SPANS) -> None:
    global _ENABLED, _spans, _dropped
    if _spans.maxlen != max_spans:
        _spans = deque(_spans, maxlen=max_spans)
    _dropped = 0
    _ENABLED = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def enabled() -> bool:
    return _ENABLED


def clear() -> None:
    global _dropped
    _spans.clear()
    _dropped = 0


def spans() -> list:
    """Finished spans, oldest first (tests and exporters)."""
    return list(_spans)


def dropped_spans() -> int:
    return _dropped


# -- export ------------------------------------------------------------


def export_chrome(path: Optional[str] = None) -> dict:
    """The buffered spans as a Chrome/Perfetto trace-event document;
    with ``path``, also written atomically (tmp + rename)."""
    events = []
    for s in list(_spans):
        args = dict(s.args)
        if s.rid is not None:
            args["rid"] = s.rid
        if s.parent is not None:
            args["parent"] = s.parent.name
        events.append({
            "name": s.name, "cat": "comdb2_tpu_torch", "ph": "X",
            "ts": round(s.t0 * 1e6, 3),
            "dur": round(((s.t1 if s.t1 is not None else s.t0)
                          - s.t0) * 1e6, 3),
            "pid": os.getpid(), "tid": 1, "args": args,
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"dropped_spans": _dropped}}
    if path is not None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
    return doc


__all__ = ["DEFAULT_MAX_SPANS", "Span", "clear", "disable",
           "dropped_spans", "enable", "enabled", "export_chrome",
           "monotonic", "record", "request", "span", "spans",
           "traced"]
