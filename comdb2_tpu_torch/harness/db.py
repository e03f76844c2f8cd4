"""DB and OS lifecycle protocols (``jepsen/db.clj``, ``jepsen/os.clj``).

The counterpart of the JAX package's ``harness/db.py``: host code, the
same protocols.
"""

from __future__ import annotations

from typing import List, Optional


class DB:
    """Set up / tear down a database on a node (``db.clj:4-8``)."""

    def setup(self, test: dict, node) -> None:
        pass

    def teardown(self, test: dict, node) -> None:
        pass


class Primary:
    """One-time setup on a single (primary) node (``db.clj:10-11``)."""

    def setup_primary(self, test: dict, node) -> None:
        pass


class LogFiles:
    """Log paths to capture from a node at test end (``db.clj:13-14``)."""

    def log_files(self, test: dict, node) -> List[str]:
        return []


class NoopDB(DB):
    pass


noop = NoopDB()


def cycle(db: DB, test: dict, node) -> None:
    """Tear down (ignoring errors), then set up (``db.clj:17-25``)."""
    try:
        db.teardown(test, node)
    except Exception:
        pass
    db.setup(test, node)


class OS:
    """Operating-system prep/teardown on a node (``os.clj:4-8``)."""

    def setup(self, test: dict, node) -> None:
        pass

    def teardown(self, test: dict, node) -> None:
        pass


class NoopOS(OS):
    pass


noop_os = NoopOS()
