"""``gc_ms_per_kop``: the collector's pauses, the seconds the window
spent in the program's ``gc.young`` and ``gc.full`` spans (one per
collection while tracing is on), in ms per thousand operations
checked."""

SPANS = ("gc.young", "gc.full")


def read(ctx):
    s = ctx.span_seconds(SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
