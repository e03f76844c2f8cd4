"""Seeded violation: a successor table of 128 x 128 entries, over the
kernel's ``MAX_TABLE`` of 8192 — the CTA keeps its one copy of the
table in shared memory (rule ``hopper-table-budget``)."""

from comdb2_tpu_torch.checker.seg_kernel import spec_for

N_STATES = 128


def big_table(P):
    return spec_for(N_STATES, 128, 4, 2)   # <- hopper-table-budget
