"""``segments_ms_per_kop``: host ingest's segmenting, the seconds the
window spent in the program's ``segments.make`` spans (``make_segments``,
both passes of the check; nested ones once) outside ``linear.decode``,
whose are the counterexample's, in ms per thousand operations
checked."""

from perfbench.lib import stages

SPANS = ("segments.make",)


def read(ctx):
    s = stages.outside_decode(ctx, SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
