"""Span tracing — monotonic clock and context-var nesting.

The subset of the JAX package's span model that the check path uses: a
span is one named interval on the process-wide monotonic clock with a
flat ``args`` dict. Nesting is implicit — entering a span makes it the
parent of every span opened inside its ``with`` block.

Off the hot path by construction: when tracing is disabled — the
default — :func:`span` returns a shared no-op after ONE module-flag
check, :func:`record` returns immediately, and :func:`traced` calls
straight through.
"""

from __future__ import annotations

import functools
import time as _time
from collections import deque
from contextvars import ContextVar
from typing import Optional

#: the one clock every stage timestamp and span shares
monotonic = _time.monotonic

#: retained-span cap; the deque drops the oldest
DEFAULT_MAX_SPANS = 200_000

_ENABLED = False
_spans: deque = deque(maxlen=DEFAULT_MAX_SPANS)

_parent_var: ContextVar = ContextVar("comdb2_tpu_torch_obs_span",
                                     default=None)


class Span:
    """One named monotonic-clock interval. Context manager; finished
    spans land in the module buffer."""

    __slots__ = ("name", "t0", "t1", "args", "parent", "_token")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args if args is not None else {}
        self.parent = _parent_var.get()
        self.t0 = monotonic()
        self.t1: Optional[float] = None
        self._token = None

    def __enter__(self) -> "Span":
        self._token = _parent_var.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _parent_var.reset(self._token)
            self._token = None
        self.t1 = monotonic()
        _spans.append(self)
        return False


class _NoopSpan:
    """The disabled-mode singleton: every method is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open one span (the shared no-op when tracing is disabled)."""
    if not _ENABLED:
        return _NOOP
    return Span(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Emit an already-measured interval as a finished span."""
    if not _ENABLED:
        return
    s = Span(name, attrs)
    s.t0 = t0
    s.t1 = t1
    _spans.append(s)


def traced(name: str):
    """Decorator form of :func:`span` for whole functions."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _ENABLED:
                return fn(*a, **kw)
            with Span(name):
                return fn(*a, **kw)
        return wrapper
    return deco


def enable(max_spans: int = DEFAULT_MAX_SPANS) -> None:
    global _ENABLED, _spans
    if _spans.maxlen != max_spans:
        _spans = deque(_spans, maxlen=max_spans)
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def spans() -> list:
    """Finished spans, oldest first."""
    return list(_spans)


__all__ = ["DEFAULT_MAX_SPANS", "Span", "disable", "enable",
           "monotonic", "record", "span", "spans", "traced"]
