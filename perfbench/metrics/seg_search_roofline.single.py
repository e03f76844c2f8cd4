"""``seg_search_roofline.single``: the segment-search kernel's share of
its roofline in its single-history launches (the launch kind
``seg_search``)."""

from perfbench.lib.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "seg_search")
