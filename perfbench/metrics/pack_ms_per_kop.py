"""``pack_ms_per_kop``: host ingest's packing, the seconds the window
spent in the program's ``ops.pack`` spans (``pack_history``, nested ones
once), in ms per thousand operations checked."""

SPANS = ("ops.pack",)


def read(ctx):
    s = ctx.span_seconds(SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
