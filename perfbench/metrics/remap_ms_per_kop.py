"""``remap_ms_per_kop``: host ingest's slot renaming, the seconds the
window spent in the program's ``segments.remap`` spans (``remap_slots``
in the check; nested ones once) outside ``linear.decode``, whose are the
counterexample's, in ms per thousand operations checked."""

from perfbench.lib import stages

SPANS = ("segments.remap",)


def read(ctx):
    s = stages.outside_decode(ctx, SPANS)
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
