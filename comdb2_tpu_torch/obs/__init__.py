"""Observability — span tracing on the monotonic clock (stdlib only)."""

from . import trace

__all__ = ["trace"]
