"""``host_ms_per_kop``: host ingest, the seconds the window spent in the
program's packing, memo and segment spans (nested ones once), in ms per
thousand operations checked."""

SPANS = ("linear.pack", "linear.segments", "batch.pack", "batch.segments",
         "batch.remap")


def read(ctx):
    s = ctx.span_seconds(SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
