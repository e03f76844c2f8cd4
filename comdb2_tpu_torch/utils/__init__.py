"""Shared utilities."""

from .device import resolve_device
from .shapes import next_pow2

__all__ = ["next_pow2", "resolve_device"]
