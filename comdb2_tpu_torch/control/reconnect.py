"""Lock-guarded auto-reopening connection wrapper
(``jepsen/reconnect.clj``): wraps any open/close pair; on an error
during use, the connection is torn down and reopened so the next caller
gets a fresh one.

The counterpart of the JAX package's ``control/reconnect.py``: host
code, the same wrapper.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class Wrapper(Generic[T]):
    def __init__(self, open_fn: Callable[[], T],
                 close_fn: Optional[Callable[[T], None]] = None,
                 name: str = "conn"):
        self.open_fn = open_fn
        self.close_fn = close_fn
        self.name = name
        self._lock = threading.RLock()
        self._conn: Optional[T] = None

    def open(self) -> "Wrapper[T]":
        with self._lock:
            if self._conn is None:
                self._conn = self.open_fn()
        return self

    def close(self) -> None:
        with self._lock:
            if self._conn is not None and self.close_fn is not None:
                try:
                    self.close_fn(self._conn)
                except Exception:
                    pass
            self._conn = None

    def reopen(self) -> None:
        """(``reconnect.clj:60-72``)"""
        with self._lock:
            self.close()
            self.open()

    def with_conn(self, f: Callable[[T], Any]) -> Any:
        """Run ``f(conn)`` under the lock; on failure, tear the
        connection down before re-raising so the next use reopens
        (``reconnect.clj:92-129``)."""
        with self._lock:
            self.open()
            try:
                return f(self._conn)
            except Exception:
                self.close()
                raise

    def with_retry(self, f: Callable[[T], Any], retries: int = 3,
                   delay: float = 0.5) -> Any:
        """with_conn + bounded retries with reopen between attempts
        (the ``control.clj:124-139`` retry-on-dropped-session shape)."""
        last: Exception = RuntimeError("no attempts")
        for attempt in range(retries):
            try:
                return self.with_conn(f)
            except Exception as e:
                last = e
                if attempt < retries - 1:   # no sleep after the last try
                    time.sleep(delay * (attempt + 1))
        raise last


def wrapper(open_fn, close_fn=None, name="conn") -> Wrapper:
    return Wrapper(open_fn, close_fn, name)
