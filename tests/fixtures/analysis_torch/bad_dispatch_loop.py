"""Seeded violation (torch twin of ``bad_dispatch_loop.py``): per-item
device dispatch in a host loop. Each call pays its own upload, launch and
readback — pack the items into one ``checker.batch.check_batch`` call
(one stream launch) or submit them to the ``comdb2_tpu_torch.service``
verifier daemon."""

from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker import seg_kernel as SK


def check_all(batches, succ):
    out = []
    for b in batches:
        out.append(LT.check_device_batch(          # <- per-item-dispatch
            succ, b.kind, b.proc, b.tr, F=256, P=4,
            n_states=8, n_transitions=16))
    return out


def check_each(histories, succ):
    # the kernel's single-history entry, one launch and one readback
    # per history
    return [SK.check_device_seg_kernel(            # <- per-item-dispatch
        succ, h.segs, n_states=8, n_transitions=16, P=4)
        for h in histories]
