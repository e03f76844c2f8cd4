"""Seeded violation (torch twin of ``bad_stream_jnp_checkpoint.py``): a
session checkpoint built with torch builders — the
``host-numpy-checkpoint`` rule. A checkpoint is an eviction/migration
artifact: built through torch it moves through the device outside the
declared kernel surface and blocks the session on the copy, where the
host numpy snapshot costs nothing and the next delta dispatch uploads
the carry anyway."""

import numpy as np
import torch


def checkpoint_carry(carry):
    states, slots, valid = carry
    wide = torch.cat([states, torch.zeros(16, dtype=states.dtype)])  # <- host-numpy-checkpoint
    return {"states": wide,
            "slots": torch.stack([slots, slots]),   # <- host-numpy-checkpoint
            "valid": np.asarray(valid)}


def restore_carry(ck, device):
    return tuple(torch.from_numpy(np.asarray(x)).to(device)  # <- host-numpy-checkpoint
                 for x in ck.values())


def checkpoint_stat(stat):
    return {"stat": stat.cuda()}   # <- host-numpy-checkpoint
