"""Shared utilities."""

from .device import (on_device, queued_ms, readback_async, resolve_device,
                     upload)
from .shapes import next_pow2

__all__ = ["next_pow2", "on_device", "queued_ms", "readback_async",
           "resolve_device", "upload"]
