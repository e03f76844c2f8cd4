"""``check_mfu``: the share of the card's peak over the device trace's
slice: the least time of everything the slice's inputs need of the
segment search, over the slice's time. It bounds every kernel's
roofline share, so a change that takes a kernel off the path cannot
hide behind that kernel's silence."""

from perfbench.lib import roofline


def read(ctx):
    ops = sum(o for o, _ in ctx.need.values())
    nbytes = sum(b for _, b in ctx.need.values())
    if not ops or ctx.peaks is None:
        return None
    return 100.0 * roofline.least_seconds(ops, nbytes, ctx.peaks) / \
        ctx.slice_s
