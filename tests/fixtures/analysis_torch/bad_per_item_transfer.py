"""Seeded violation (torch twin of ``bad_per_item_transfer.py``):
host-to-device transfer inside a per-item loop (rule
``per-item-transfer``).

N carries copied to the card one ``.to(device)`` at a time pay N copies,
and a blocking copy of host memory holds the host until the card has
drained. Batch the items and ride ONE upload."""

import torch


def restore_all(self, snapshots, device):
    carries = []
    for snap in snapshots:
        carries.append(torch.from_numpy(snap).to(device))  # <- per-item-transfer
    return carries


def stage_all(self, rows):
    out = []
    for r in rows:
        out.append(torch.tensor(r, device="cuda"))   # <- per-item-transfer
    return out
