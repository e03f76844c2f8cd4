"""Completion-pair-aware ddmin over columnar op tables.

The counterpart of the JAX package's ``shrink/core.py``. A Jepsen-style
fault-window run hands in a 100k-event history and a bare INVALID;
debugging the system under test means finding a *small* sub-history
that still fails. Classic delta debugging (ddmin, Zeller & Hildebrandt
2002) is serial: test one candidate, look at the verdict, pick the
next. Here every round's whole candidate set is generated as columnar
row slices of one packed parent (no Op materialization, no re-packing:
:func:`~..checker.batch.pack_batch_masked`) and verdict-tested in ONE
launch per pow2 shape bucket (:mod:`.verdicts`).

The drop unit is the invoke/complete pair, never a half-op (a lone
completion would desynchronise the per-process alternation every
segment pass checks); pending invokes are single-row atoms, and
``:info`` ops stay pinned: an indeterminate op can never be proven
irrelevant. After the ddmin granularity ladder, a greedy single-pair
elimination endgame runs until a full round removes nothing; that final
round is the 1-minimality certificate: removing any remaining pair
yields VALID or UNKNOWN.

Seeds that are not INVALID are an error, not a loop
(:class:`SeedVerdictError`): shrinking an UNKNOWN could oscillate
between capacity-limited verdicts, and a VALID history has nothing to
preserve. ``device``: ``None`` means ``cuda``; there is no fallback to
the CPU when no card is found.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

from ..checker import linear_torch as LT
from ..obs import trace as _obs
from ..models.memo import memoize_model, transitions_of
from ..models.model import MODELS, Model
from ..ops.op import INFO, INVOKE, Op
from ..ops.packed import PackedHistory, pack_history
from ..utils import resolve_device
from .verdicts import MAX_BATCH, check_candidates

#: engine status -> the checker tri-state
_STATUS_NAME = {LT.VALID: True, LT.INVALID: False, LT.UNKNOWN: "unknown"}


class SeedVerdictError(ValueError):
    """The history to minimize is not INVALID. ``verdict`` carries the
    tri-state actually observed (True / "unknown")."""

    def __init__(self, verdict, msg: str):
        super().__init__(msg)
        self.verdict = verdict


@dataclass
class ShrinkResult:
    """What the minimizer hands back. ``ops`` is the minimal
    sub-history (re-indexed, materialized at this API edge only);
    ``one_minimal`` is True iff the final greedy round certified that
    removing any remaining atom flips the verdict; ``partial`` marks a
    deadline/round-cap abort (best-so-far, NOT certified)."""

    checker: str
    valid: Union[bool, str]      # False once the seed is confirmed
    ops: List[Op]
    seed_ops: int
    n_ops: int
    rounds: int
    candidates: int
    dispatches: int
    one_minimal: bool
    partial: bool
    extra: dict = field(default_factory=dict)


def atoms_of(packed: PackedHistory):
    """Droppable atoms + pinned rows of a packed history.

    Returns ``(atoms, pinned)``: ``atoms`` is a list of int row-index
    arrays — one per completed invoke/complete pair (2 rows) or lone
    pending invoke (1 row), in invocation order; ``pinned`` is a
    ``bool[n]`` mask of rows every candidate keeps (``:info`` rows and
    their crashed invokes — plus, by construction, nothing else).
    Vectorized over the packed columns; Op objects are never touched.
    """
    n = len(packed)
    t = np.asarray(packed.type)
    proc = np.asarray(packed.process)
    pair = np.asarray(packed.pair)
    pinned = t == INFO
    inv = np.flatnonzero(t == INVOKE)
    paired = inv[pair[inv] >= 0]
    unpaired = inv[pair[inv] < 0]
    if unpaired.size:
        # next same-process row via one stable argsort: an unpaired
        # invoke whose successor is an :info row is a crashed op —
        # pinned with its completion (indeterminate, may have applied)
        order = np.argsort(proc, kind="stable")
        nxt = np.full(n, -1, np.int64)
        same = proc[order][1:] == proc[order][:-1]
        nxt[order[:-1][same]] = order[1:][same]
        has_nxt = nxt[unpaired] >= 0
        crashed = unpaired[has_nxt & (
            t[np.clip(nxt[unpaired], 0, n - 1)] == INFO)]
        pinned[crashed] = True
        pending = unpaired[~np.isin(unpaired, crashed)]
    else:
        pending = unpaired
    atoms = [np.array([i, pair[i]], np.int64) for i in paired.tolist()]
    atoms += [np.array([i], np.int64) for i in pending.tolist()]
    atoms.sort(key=lambda a: int(a[0]))
    return atoms, pinned


def _chunks(ids: List[int], n: int) -> List[List[int]]:
    """``ids`` split into ``n`` near-equal contiguous chunks."""
    out, start = [], 0
    for k in range(n):
        end = start + (len(ids) - start) // (n - k)
        out.append(ids[start:end])
        start = end
    return [c for c in out if c]


class DdminEngine:
    """The shared step-driven phase machine both axes run.

    One :meth:`step` call runs one shrink **round**, a full candidate
    set generated and verdict-tested in one batched launch per shape
    bucket, and returns True when minimization is finished;
    :func:`minimize` loops it with a deadline.

    Phases: ``seed`` (confirm the parent is INVALID at this engine/F —
    anything else sets :attr:`error` to a :class:`SeedVerdictError`)
    -> ``ddmin`` (granularity ladder) -> ``greedy`` (single-atom
    elimination; the final no-op round is the 1-minimality
    certificate) -> ``done``.

    Subclasses provide ``_seed_round()`` (establish ``self.cur`` or
    set ``self.error``/finish) and ``_test(cand_sets) -> bool array``
    ("still INVALID" per candidate atom-id set), plus ``result()``.

    ``round_cap`` bounds the candidates one round may test (an
    uncapped greedy round over a mostly irreducible 10k-op seed is
    thousands of candidates). Capped greedy tests a rotating window
    per round and certifies 1-minimality only after a full consecutive
    clean sweep; the fine ddmin ladder hands over to it once its
    candidate sets would exceed the cap. ``None`` (the API default)
    keeps classic whole-round ddmin.
    """

    def __init__(self, round_cap: Optional[int] = None):
        self.cur: List[int] = []
        self.phase = "seed"
        self.gran = 2
        self.rounds = 0
        self.round_cap = round_cap
        self._greedy_pos = 0
        self._greedy_clean = 0
        self.counters = {"dispatches": 0, "candidates": 0}
        self.one_minimal = False
        self.error: Optional[SeedVerdictError] = None

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def step(self) -> bool:
        """Run one round; True when minimization is finished."""
        with _obs.span("shrink.step", phase=self.phase,
                       rounds=self.rounds):
            if self.phase == "seed":
                self._seed_round()
            elif self.phase == "ddmin":
                self._ddmin_round()
            elif self.phase == "greedy":
                self._greedy_round()
        return self.phase == "done"

    def _ddmin_round(self) -> None:
        n = min(self.gran, len(self.cur))
        if self.round_cap is not None and 2 * n > self.round_cap:
            # bounded mode: the fine ladder's candidate sets no longer
            # fit one round's budget; the capped greedy endgame covers
            # the same single-atom eliminations
            self.phase = "greedy"
            self._greedy_round()
            return
        chunks = _chunks(self.cur, n)
        cands = list(chunks)
        if n > 2:                       # at n == 2 each complement IS
            for k in range(len(chunks)):  # the other chunk
                cands.append([a for j, c in enumerate(chunks)
                              for a in c if j != k])
        surv = self._survivors(cands)
        invalid = np.flatnonzero(surv)
        if invalid.size:
            best = min(invalid.tolist(), key=lambda i: len(cands[i]))
            self.cur = cands[best]
            # reduce-to-subset restarts the ladder; reduce-to-
            # complement keeps (n-1) chunks' worth of granularity
            self.gran = 2 if best < len(chunks) else max(n - 1, 2)
        elif n >= len(self.cur):
            self.phase = "greedy"
        else:
            self.gran = min(n * 2, len(self.cur))
        if len(self.cur) <= 1:
            self.phase = "greedy"

    def _greedy_round(self) -> None:
        if not self.cur:
            # a candidate with zero atoms can only be trivially VALID,
            # so an empty cur means the pinned rows alone never fail —
            # nothing left to certify
            self.one_minimal = True
            self.phase = "done"
            return
        n = len(self.cur)
        take = n if self.round_cap is None else min(self.round_cap, n)
        ks = [(self._greedy_pos + i) % n for i in range(take)]
        cands = [self.cur[:k] + self.cur[k + 1:] for k in ks]
        surv = self._survivors(cands)
        invalid = np.flatnonzero(surv)
        if invalid.size:
            # drop ONE atom per round — single removals interact, so
            # anything beyond the first must be re-certified anyway
            k = ks[int(invalid[0])]
            self.cur = self.cur[:k] + self.cur[k + 1:]
            self._greedy_clean = 0
            self._greedy_pos = k % max(len(self.cur), 1)
            return
        # certificate accounting: 1-minimality needs a FULL
        # consecutive clean sweep (every single-atom removal flipped
        # the verdict with no drop in between)
        self._greedy_clean += take
        self._greedy_pos = (self._greedy_pos + take) % n
        if self._greedy_clean >= n:
            self.one_minimal = True
            self.phase = "done"

    def _survivors(self, cand_sets: List[List[int]]) -> np.ndarray:
        """bool[B]: which candidates are still INVALID."""
        self.rounds += 1
        return self._test(cand_sets)

    def _seed_round(self) -> None:          # pragma: no cover
        raise NotImplementedError

    def _test(self, cand_sets):             # pragma: no cover
        raise NotImplementedError


class Shrinker(DdminEngine):
    """Minimizer for the linearizability axis (see
    :class:`DdminEngine` for the phase machine): drop atoms are
    invoke/complete pairs of the packed parent, candidates are
    columnar row masks, and each round's verdicts ride
    :func:`~.verdicts.check_candidates` on ``device``."""

    checker = "linear"

    def __init__(self, history: Union[Sequence[Op], PackedHistory],
                 model: Union[Model, str, None] = None, *,
                 F: int = 1024, engine: str = "auto", mesh=None,
                 max_states: int = 1 << 20,
                 max_batch: int = MAX_BATCH,
                 round_cap: Optional[int] = None, device=None):
        super().__init__(round_cap)
        self.device = resolve_device(device)
        if isinstance(model, str) or model is None:
            model = MODELS[model or "cas-register"]()
        self.packed = (history if isinstance(history, PackedHistory)
                       else pack_history(list(history)))
        self.F = F
        self.engine = engine
        self.mesh = mesh
        self.max_batch = max_batch
        self.atoms, self.pinned = atoms_of(self.packed)
        n_inv = int(((np.asarray(self.packed.type) == INVOKE)
                     & ~np.asarray(self.packed.fails)).sum())
        # ONE memo serves every round: candidates are row subsets of
        # the parent, so their transitions and invoke counts are
        # bounded by the parent's
        self.memo = memoize_model(model, transitions_of(self.packed),
                                  max_states=max_states,
                                  max_depth=max(n_inv, 1))
        self.cur = list(range(len(self.atoms)))

    # -- candidate plumbing --------------------------------------------

    def mask_of(self, atom_ids: Sequence[int]) -> np.ndarray:
        m = self.pinned.copy()
        if len(atom_ids):
            m[np.concatenate([self.atoms[a] for a in atom_ids])] = True
        return m

    def _statuses(self, cand_sets: List[List[int]]) -> np.ndarray:
        return check_candidates(
            self.packed, [self.mask_of(s) for s in cand_sets],
            self.memo, F=self.F, engine=self.engine, mesh=self.mesh,
            max_batch=self.max_batch, counters=self.counters,
            device=self.device)

    def _test(self, cand_sets: List[List[int]]) -> np.ndarray:
        return self._statuses(cand_sets) == LT.INVALID

    # -- the rounds ----------------------------------------------------

    def _seed_round(self) -> None:
        self.rounds += 1
        st = int(self._statuses([self.cur])[0])
        if st != LT.INVALID:
            v = _STATUS_NAME[st]
            self.error = SeedVerdictError(
                v, f"seed verdict is {v!r} — only INVALID histories "
                   "shrink (an UNKNOWN seed would loop on capacity-"
                   "limited verdicts, a VALID one has nothing to "
                   "preserve)")
            self.phase = "done"
            return
        self.phase = "ddmin" if len(self.cur) >= 2 else "greedy"

    # -- results -------------------------------------------------------

    def result(self, partial: bool = False) -> ShrinkResult:
        from ..ops.columnar import subset_packed

        mask = self.mask_of(self.cur)
        sub = subset_packed(self.packed, mask)
        return ShrinkResult(
            checker=self.checker,
            valid=(False if self.phase != "seed"
                   and self.error is None else "unknown"),
            ops=sub.ops,                 # API edge: re-indexed Op list
            seed_ops=len(self.packed), n_ops=len(sub),
            rounds=self.rounds,
            candidates=self.counters["candidates"],
            dispatches=self.counters["dispatches"],
            one_minimal=self.one_minimal and not partial,
            partial=partial)


def minimize(history, *, checker: str = "linear",
             model: Union[Model, str, None] = None,
             realtime: bool = False, F: int = 1024,
             engine: str = "auto", mesh=None,
             max_states: int = 1 << 20,
             deadline_s: Optional[float] = None,
             max_rounds: int = 100_000, device=None) -> ShrinkResult:
    """Minimize an INVALID history to a 1-minimal sub-history.

    ``checker="linear"`` runs completion-pair ddmin against ``model``
    (name or instance, default cas-register); ``checker="txn"`` runs
    txn-granularity minimal-cycle shrink over the dependency graph
    (:class:`~.txn.TxnShrinker`). Raises :class:`SeedVerdictError`
    when the seed is VALID or UNKNOWN. ``deadline_s`` returns
    best-so-far flagged ``partial`` instead of running to the
    certificate. ``device``: ``None`` means ``cuda``.
    """
    if checker == "txn":
        from .txn import TxnShrinker

        job = TxnShrinker(history, realtime=realtime, mesh=mesh,
                          device=device)
    elif checker == "linear":
        job = Shrinker(history, model, F=F, engine=engine, mesh=mesh,
                       max_states=max_states, device=device)
    else:
        raise ValueError(f"no shrinker for checker {checker!r}")
    t0 = _obs.monotonic()
    while not job.step():
        if deadline_s is not None \
                and _obs.monotonic() - t0 >= deadline_s:
            return job.result(partial=True)
        if job.rounds >= max_rounds:
            return job.result(partial=True)
    if job.error is not None:
        raise job.error
    return job.result()


__all__ = ["DdminEngine", "SeedVerdictError", "ShrinkResult",
           "Shrinker", "atoms_of", "minimize"]
