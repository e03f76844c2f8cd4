"""Seeded violation: a segment-search spec asked for 16 slots; the
kernel's layout holds at most 15 (``MAX_P``) — rule ``hopper-p-cap``."""

from comdb2_tpu_torch.checker import seg_kernel as SK


def sixteen_slots():
    return SK.spec_for(n_states=8, n_transitions=32, P=16, K=2)   # <- hopper-p-cap
