"""Static-shape bucketing helpers.

XLA compiles one program per distinct input shape; rounding capacities
and history lengths up to powers of two keeps the number of compiled
variants logarithmic in problem size.
"""

from __future__ import annotations


def next_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    p = lo
    while p < n:
        p *= 2
    return p
