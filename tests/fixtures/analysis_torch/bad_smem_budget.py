"""Seeded violation: a CTA's dynamic shared memory over what a Hopper
CTA may opt into (232,448 bytes): eight warps at the widest layout over
a 60,000-entry table — the launch would be refused (rule
``hopper-smem-budget``)."""

from comdb2_tpu_torch.analysis.kernel_budget import smem_bytes
from comdb2_tpu_torch.checker.seg_kernel import spec_for


def plan():
    return smem_bytes(spec_for(256, 8, 15, 8), 60000, 8)   # <- hopper-smem-budget
