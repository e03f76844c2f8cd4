"""Seeded violation: a segment-search spec asked for K = 9 invokes per
segment; the kernel serves at most 8 (``MAX_K``: the row ring and the
invoke loop are sized for it) — rule ``hopper-k-cap``."""

from comdb2_tpu_torch.checker.seg_kernel import spec_for


def wide_spec():
    return spec_for(8, 32, 3, 9)   # <- hopper-k-cap
