"""The Jepsen harness: only the results store (:mod:`.store`) is ported
so far; it persists shrink runs and the checker objects' artifacts."""

from . import store

__all__ = ["store"]
