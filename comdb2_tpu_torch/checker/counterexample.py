"""Bounded counterexample reconstruction for INVALID verdicts.

The role of the reference's ``final-paths`` (``knossos/linear.clj:
180-212``): turn "the frontier died at op i" into concrete failed
linearization orders a human can read, without re-running the whole
history on the host:

1. Re-scan the history with the segment-search kernel one chunk per
   launch (:func:`~.seg_kernel.check_device_seg_kernel_chunked`),
   keeping the frontier at the last chunk boundary BEFORE the frontier
   died; it decodes directly into host configs.
2. Replay at most one chunk of segments on host from that frontier
   (:func:`~.linear_host.check` with ``start_index``/``init_configs``)
   to recover the exact dying op, the closed frontier at death, and
   the pre-closure frontier.
3. DFS the pre-closure frontier's pending-call orders against the
   memoized model graph to produce ``final paths`` — each path is a
   sequence of (op, resulting model state) ending in the step that
   made the model inconsistent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set

from ..models.memo import MemoizedModel
from ..ops.packed import PackedHistory
from ..utils import next_pow2 as _next_pow2
from . import linear_host
from .linear_host import IDLE, LIN, Config


@dataclass
class Counterexample:
    op_index: int                      # history index where search died
    configs: List[dict]                # decoded closed frontier at death
    paths: List[list] = field(default_factory=list)  # final paths
    raw_configs: List[Config] = field(default_factory=list)
    replayed_segments: int = 0         # host-replay bound (diagnostics)


def _unmap_configs(cfgs, owners_row, P: int) -> Set[Config]:
    """Map configs decoded in renamed-slot space (see
    :func:`~.linear_torch.remap_slots`) back to process-indexed slots of
    width ``P``. ``owners_row`` is the slot -> original-process map at
    the decoded segment boundary; a non-IDLE slot (pending OR
    linearized-but-not-returned) always has an owner there — the map
    only frees a slot at its ok."""
    out: Set[Config] = set()
    for (st, sl) in cfgs:
        slots = [IDLE] * P
        for q, t in enumerate(sl):
            if t == IDLE:
                continue
            p = int(owners_row[q]) if q < len(owners_row) else -1
            if p < 0:
                raise ValueError(
                    f"occupied slot {q} has no owning process at the "
                    "decoded boundary — owner map out of sync")
            slots[p] = t
        out.add((int(st), tuple(slots)))
    return out


def reconstruct(mm: MemoizedModel, packed: PackedHistory,
                max_paths: int = 10,
                max_host_configs: int = 1 << 16, device=None
                ) -> Optional[Counterexample]:
    """Reconstruct the counterexample for a history the kernel judged
    INVALID. Returns None when the re-scan does not reproduce the
    failure. The host replays at most one re-scan chunk
    (``seg_kernel.CHUNK`` segments)."""
    from . import linear_torch as LT
    from .linear import kernel_slots

    P = len(packed.process_table)
    # the same shape buckets AND slot renaming as
    # linear._analyze_device. The kernel frontier decodes in
    # renamed-slot space; ``owners`` (slot -> original process, per
    # segment) maps it back before the host replay, which speaks
    # process-indexed slots.
    segs = LT.make_segments(packed)
    S = segs.ok_proc.shape[0]
    segs = LT.make_segments(
        packed, s_pad=_next_pow2(S, 64),
        k_pad=_next_pow2(segs.inv_proc.shape[1], 2))
    segs, P_eff, owners = LT.remap_slots(segs, with_maps=True)
    sizes = {"n_states": mm.n_states, "n_transitions": mm.n_transitions}
    boundary = _kernel_boundary(mm, segs, kernel_slots(P_eff), sizes,
                                device)
    if boundary is None:
        return None
    raw_cfgs, done, fail_seg = boundary
    boundary_cfgs = _unmap_configs(
        raw_cfgs, owners[done - 1] if done > 0 else (), P)

    # host replay: from the history row after the boundary's last ok
    start_index = (int(segs.seg_index[done - 1]) + 1) if done > 0 else 0
    r = linear_host.check(mm, packed, max_configs=max_host_configs,
                          start_index=start_index,
                          init_configs=boundary_cfgs)
    if r.valid or r.op_index is None:
        return None                           # replay didn't reproduce
    cfgs = [linear_host.describe_config(mm, packed, c)
            for c in r.configs[:10]]
    paths = final_paths(mm, packed, r.pre_configs, r.op_index,
                        max_paths=max_paths)
    return Counterexample(op_index=r.op_index, configs=cfgs,
                          paths=paths, raw_configs=r.configs[:10],
                          replayed_segments=max(fail_seg - done + 1, 0))


def _kernel_boundary(mm, segs, P_k: int, sizes, device):
    """Run the kernel's chunked scan and return ``(boundary_configs,
    done, fail_seg)``, or None when the kernel can't serve this shape
    or didn't reproduce the INVALID."""
    from . import seg_kernel as SK

    r = SK.check_device_seg_kernel_chunked(
        mm.succ, segs, P=P_k, return_boundary=True, device=device,
        **sizes)
    if r is None or r[0] != SK.INVALID:
        return None
    status, fail_seg, _n, (ws, done) = r
    spec = SK.spec_for(sizes["n_states"], sizes["n_transitions"], P_k,
                       segs.inv_proc.shape[1])
    return SK.decode_frontier(spec, ws, P_k), done, fail_seg


def _op_desc(packed: PackedHistory, q: int, t: int) -> dict:
    """Human-readable pending call: process + (f, value)."""
    f_id, v_id = packed.transition_table[t]
    return {"process": packed.process_table[q],
            "f": packed.f_table[f_id],
            "value": packed.value_table[v_id]}


def final_paths(mm: MemoizedModel, packed: PackedHistory,
                configs: List[Config], op_index: int,
                max_paths: int = 10) -> List[list]:
    """Concrete failed linearization orders (``linear.clj:180-212``).

    For each seed config (the frontier just before the dying ok's
    closure), walk orders of pending calls through the memoized model
    graph; every branch ends in the step that made the model
    inconsistent. Each path is a list of ``{"op": ..., "model": ...}``
    entries whose last model is ``"inconsistent"``."""
    succ = mm.succ
    paths: List[list] = []

    def dfs(s: int, slots, acc) -> None:
        if len(paths) >= max_paths:
            return
        pend = [q for q, t in enumerate(slots) if t >= 0]
        if not pend:
            # every call linearized yet the config died — only possible
            # for malformed input; record it rather than drop the path
            paths.append(acc + [{"op": "(nothing pending)",
                                 "model": "returning process never "
                                          "linearized"}])
            return
        for q in pend:
            if len(paths) >= max_paths:
                return
            t = slots[q]
            s2 = int(succ[s][t])
            opd = _op_desc(packed, q, t)
            if s2 < 0:
                paths.append(acc + [{"op": opd,
                                     "model": "inconsistent"}])
            else:
                dfs(s2, slots[:q] + (LIN,) + slots[q + 1:],
                    acc + [{"op": opd,
                            "model": mm.states[s2].describe()}])

    ok_p = int(packed.process[op_index])
    for (s, slots) in configs:
        if len(paths) >= max_paths:
            break
        # paths that linearize the returning call and survive would
        # contradict the INVALID verdict, so the DFS only ever emits
        # dead ends; seed with the config's current model state
        dfs(int(s), tuple(slots),
            [{"op": "(state before %r returns)"
                    % (packed.process_table[ok_p],),
              "model": mm.states[int(s)].describe()}])
    return paths[:max_paths]
