"""``call_s_p95``: the 95th percentile, by nearest rank, of every call's
time in the window on the benchmark's own clock."""

import math


def read(ctx):
    t = sorted(c.t1 - c.t0 for c in ctx.calls if c.error is None)
    return t[math.ceil(0.95 * len(t)) - 1] if t else None
