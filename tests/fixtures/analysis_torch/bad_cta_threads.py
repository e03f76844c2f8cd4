"""Seeded violation: a CTA of 40 warps, 1,280 threads, over the 1,024
of one Hopper CTA (rule ``hopper-cta-threads``)."""

from comdb2_tpu_torch.analysis.kernel_budget import smem_bytes
from comdb2_tpu_torch.checker.seg_kernel import spec_for


def plan():
    return smem_bytes(spec_for(8, 32, 1, 1), 32, 40)   # <- hopper-cta-threads
