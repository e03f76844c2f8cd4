"""Host reference implementation of just-in-time linearization.

Implements the semantics of the reference's primary checker —
``knossos/linear.clj`` (Lowe's JIT-linearization algorithm) — over the
memoized model graph, in the exact representation the device engines use,
so the two can be cross-validated row for row.

A *config* is ``(state_id, slots)``:

- ``state_id`` — node in the memoized transition graph
  (:class:`~comdb2_tpu_torch.models.memo.MemoizedModel`).
- ``slots`` — one entry per process: ``IDLE`` (-1), ``LIN`` (-2: this
  process's current call is linearized but hasn't returned), or a
  transition id ≥ 0 (process is calling that transition). This is the
  fixed-width tensor form of the reference's ``ArrayProcesses`` packed
  int array (``knossos/linear/config.clj:157-295``); which *op* a busy
  process is running is recoverable from the history prefix, so storing
  the transition id loses nothing and dedups strictly more configs.

Per history op (``linear.clj:218-271``):

- ``invoke`` (unless the op is known to fail): set the process's slot to
  the op's transition id in every config (``t-call``).
- ``ok``: close the config set under single-call linearization — for any
  config and any calling process ``q``, if ``succ[state, slot[q]]`` is
  consistent, add the config with ``q`` marked ``LIN`` — then keep only
  configs where the returning process is ``LIN`` and idle it
  (``t-lin``/``t-ret``). Empty result ⇒ not linearizable at this op.
  The closure is the fixed point of the reference's per-``ok`` DFS over
  pending-call orders (``jit-linearizations``, ``linear.clj:66-99``);
  closing under *all* pending calls (not only those ending with the
  returning op) only adds configs that a later return point would have
  produced anyway, so the set stays exactly the reachable-config set.
- ``fail`` / ``info``: no-op (failed invokes never entered; info calls
  stay pending forever and remain linearizable in later closures —
  ``history.clj:127-145``, ``linear.clj:226``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from ..models.memo import MemoizedModel
from ..ops.op import INVOKE, OK
from ..ops.packed import PackedHistory

IDLE = -1
LIN = -2

Config = Tuple[int, Tuple[int, ...]]


class FrontierOverflow(Exception):
    """Config set exceeded the cap — analysis result is :unknown,
    mirroring the reference's low-memory abort (``linear.clj:318-326``)."""


@dataclass
class HostResult:
    valid: bool
    op_index: Optional[int] = None      # history index where search died
    configs: List[Config] = field(default_factory=list)  # frontier sample
    final_count: int = 0
    max_frontier: int = 0               # peak |configs| over the run
    # on failure: the frontier JUST BEFORE the dying ok's closure — the
    # seeds for final-path reconstruction (``linear.clj:180-212``)
    pre_configs: List[Config] = field(default_factory=list)


def closure(configs: Set[Config], succ,
            max_configs: Optional[int] = None) -> Set[Config]:
    """Close ``configs`` under linearizing any one pending call. The cap
    is enforced *during* expansion so an adversarial history aborts to
    :unknown instead of exhausting memory."""
    seen = set(configs)
    frontier = list(configs)
    while frontier:
        new = []
        for (s, slots) in frontier:
            row = succ[s]
            for q, t in enumerate(slots):
                if t >= 0:
                    s2 = int(row[t])
                    if s2 >= 0:
                        c2 = (s2, slots[:q] + (LIN,) + slots[q + 1:])
                        if c2 not in seen:
                            seen.add(c2)
                            new.append(c2)
                            if max_configs and len(seen) > max_configs:
                                raise FrontierOverflow(
                                    f"config set exceeds {max_configs}")
        frontier = new
    return seen


def check(memo: MemoizedModel, packed: PackedHistory,
          max_configs: int = 1 << 22, start_index: int = 0,
          init_configs: Optional[Set[Config]] = None) -> HostResult:
    """Run the search over a packed history. Raises
    :class:`FrontierOverflow` if the config set ever exceeds
    ``max_configs``.

    ``start_index``/``init_configs`` resume the search mid-history from
    a known frontier (e.g. a device scan's chunk-boundary carry) — the
    bounded counterexample-reconstruction path replays at most one
    chunk on host instead of the whole history."""
    P = len(packed.process_table)
    succ = memo.succ
    configs: Set[Config] = (set(init_configs) if init_configs is not None
                            else {(0, (IDLE,) * P)})
    peak = len(configs)
    for i in range(start_index, len(packed)):
        t = int(packed.type[i])
        if t == INVOKE:
            if packed.fails[i]:
                continue
            p = int(packed.process[i])
            tr = int(packed.trans[i])
            configs = {(s, slots[:p] + (tr,) + slots[p + 1:])
                       for (s, slots) in configs}
        elif t == OK:
            p = int(packed.process[i])
            pre = configs
            closed = closure(configs, succ, max_configs)
            peak = max(peak, len(closed))
            configs = {(s, slots[:p] + (IDLE,) + slots[p + 1:])
                       for (s, slots) in closed if slots[p] == LIN}
            if not configs:
                return HostResult(valid=False, op_index=i,
                                  configs=sorted(closed)[:16],
                                  final_count=0, max_frontier=peak,
                                  pre_configs=sorted(pre)[:16])
        # fail / info: no-op
    return HostResult(valid=True, final_count=len(configs),
                      configs=sorted(configs)[:16], max_frontier=peak)


def describe_config(memo: MemoizedModel, packed: PackedHistory,
                    config: Config) -> dict:
    """Decode a config back to model state + per-process status, for
    counterexample reports (the role of ``final-paths``,
    ``linear.clj:180-212``)."""
    s, slots = config
    pending = {}
    for p, t in enumerate(slots):
        name = packed.process_table[p]
        if t == LIN:
            pending[name] = "linearized"
        elif t >= 0:
            f_id, v_id = packed.transition_table[t]
            pending[name] = (packed.f_table[f_id], packed.value_table[v_id])
    return {"model": memo.states[s].describe(), "pending": pending}
