"""Seeded violation (torch twin of ``bad_unbucketed_shape.py``):
unbucketed shapes at an engine entry. Per-seed shapes put each seed on a
table and kernel layout of its own — pad sizes to the declared buckets
(pow2 pads, the fuzz bucket ladder)."""

from comdb2_tpu_torch.checker import linear_torch as LT


def check(packed, succ):
    bucket = (13, 37)                  # <- jaxpr-unbucketed-shape
    segs = LT.make_segments(packed, s_pad=64, k_pad=8)
    return LT.check_device_seg(        # <- jaxpr-unbucketed-shape
        succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth,
        F=128, P=4, n_states=24, n_transitions=bucket[1])
