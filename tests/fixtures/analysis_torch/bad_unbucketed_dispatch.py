"""Seeded violation (torch twin of ``bad_unbucketed_dispatch.py``): raw
(unbucketed) shapes reach a batch dispatch site — laundered through a
helper function, so only the INTERPROCEDURAL chase of the
``unbucketed-dispatch-site`` rule can tie the raw ``memo.n_states`` at
the call site to the engine entry's shape argument."""

from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.checker.batch import check_batch


def _dispatch(succ, sb, n_states, n_transitions):
    # the sink: a batched engine entry whose shape args come from the
    # caller's parameters
    return LT.check_device_seg_batch(   # <- unbucketed-dispatch-site
        succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth,
        F=128, P=4, n_states=n_states, n_transitions=n_transitions)


def check_all(batches):
    out = []
    for memo, sb in batches:
        # BUG: raw memo counts, no next_pow2
        out.append(_dispatch(memo.succ, sb, memo.n_states,
                             memo.n_transitions))
    return out


def check_one(batch, items):
    # BUG: a raw item count as the segment floor
    return check_batch(batch, s_pad=len(items))   # <- unbucketed-dispatch-site
