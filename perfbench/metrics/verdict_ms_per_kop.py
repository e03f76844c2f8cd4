"""``verdict_ms_per_kop``: the verdict layer, the seconds the window
spent in the program's decode (counterexample included), collect and
finalize spans, in ms per thousand operations checked."""

SPANS = ("linear.decode", "batch.collect", "batch.finalize")


def read(ctx):
    s = ctx.span_seconds(SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
