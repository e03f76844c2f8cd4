"""Result-formatting helpers.

The compact integer-interval rendering of set results and the safe
fraction mirror the reference's ``jepsen/util.clj:483-508`` and
``checker.clj`` ``fraction``.
"""

from __future__ import annotations

from typing import Iterable


def fraction(a: int, b: int) -> float:
    """a/b, but 1 when b is zero (vacuously complete)."""
    return 1.0 if b == 0 else a / b


def integer_interval_set_str(xs: Iterable) -> str:
    """Sorted, compact string for a set of integers:
    ``#{1..3 5 9..10}``. Non-integer or None members fall back to a
    plain sorted rendering (``util.clj:483-508``)."""
    xs = list(xs)
    if any(x is None or not isinstance(x, int) for x in xs):
        return "#{" + " ".join(str(x) for x in sorted(xs, key=repr)) + "}"
    runs = []
    start = end = None
    for cur in sorted(xs):
        if start is None:
            start = end = cur
        elif cur == end + 1:
            end = cur
        else:
            runs.append((start, end))
            start = end = cur
    if start is not None:
        runs.append((start, end))
    body = " ".join(str(a) if a == b else f"{a}..{b}" for a, b in runs)
    return "#{" + body + "}"
