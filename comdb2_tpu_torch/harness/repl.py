"""Interactive helpers (``jepsen/repl.clj`` + ``jepsen/report.clj``):
reload the latest run and re-check it offline; capture stdout to a
file.

The counterpart of the JAX package's ``harness/repl.py``: a re-check
runs the port's checkers, on the device each was built with.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from ..checker.checkers import check_safe
from . import store


def last_test(name: str, store_root: str = "store") -> Optional[dict]:
    """The most recent persisted run of a test (``repl.clj:6-13``)."""
    return store.latest(name, store_root)


def recheck(test: dict, checker, model=None) -> dict:
    """Re-run a checker over a reloaded test's history — analysis is
    replayable from the persisted artifact (``store.clj:159-165``)."""
    return check_safe(checker, test, model, test.get("history") or [])


@contextlib.contextmanager
def to_file(path: str):
    """Redirect stdout into a report file (``report.clj``)."""
    with open(path, "w") as fh, contextlib.redirect_stdout(fh):
        yield fh
