"""Seeded violation (torch twin of ``bad_stream_unbucketed_delta.py``):
raw (unbucketed) shapes reach the streaming-session delta entry
``stream_delta_chunk`` — every append that grew the alphabet would
size the session's tables per growth step instead of on the
``stream.engine.pad_sizes`` pow2 buckets."""

from comdb2_tpu_torch.checker import linear_torch as LT
from comdb2_tpu_torch.stream.engine import stream_delta_chunk


def _dispatch_delta(succ, ip, it, okp, dp, off, carry, n_states,
                    n_transitions):
    return stream_delta_chunk(   # <- unbucketed-dispatch-site
        succ, ip, it, okp, dp, off, carry, F=256, Fs=32, P=4,
        n_states=n_states, n_transitions=n_transitions)


def append_all(session, deltas):
    carry = LT.init_seg_carry(256, 4)
    for memo, (ip, it, okp, dp, off) in deltas:
        # BUG: raw memo counts, no pad_sizes/next_pow2
        carry = _dispatch_delta(session.succ_dev, ip, it, okp, dp,
                                off, carry, memo.n_states,
                                memo.n_transitions)
    return carry
