"""Shared utilities."""

from .device import queued_ms, resolve_device
from .shapes import next_pow2

__all__ = ["next_pow2", "queued_ms", "resolve_device"]
