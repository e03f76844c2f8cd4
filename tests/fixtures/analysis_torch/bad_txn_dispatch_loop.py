"""Seeded violation (torch twin of ``bad_txn_dispatch_loop.py``):
per-graph device dispatch in a host loop. N dependency graphs must be
padded to one bucket and stacked through ``closure_diag_batch`` (or
submitted to the verifier daemon's ``txn`` request kind)."""

import numpy as np

from comdb2_tpu_torch.txn.closure_torch import closure_diag


def classify_all(graphs):
    out = []
    for g in graphs:
        out.append(closure_diag(              # <- per-item-dispatch
            g.padded(np.int32(64))))
    return out
