"""What every traffic kind's caller shares: a pool of single histories
made from the seed, the units it answers for, the sample that the plain
reference checks, and what the reference says a unit needs of the
segment search.

A caller (``perfbench/traffic/<kind>.py``'s ``Caller``) subclasses
:class:`PoolCaller` and gives ``setup`` (the program, its inputs, the
warm-up) and ``call(j)``, which returns the operations it checked and
its answer per unit (:func:`perfbench.lib.harness.answer`). A kind with
other inputs overrides ``make_pool``, ``units``, ``history``,
``mutated`` and ``ops``, and ``need`` (or drops it: the rooflines then
read nothing).
"""

from __future__ import annotations

from perfbench.gen.pool import default_workers, single_pool
from perfbench.lib import roofline
from perfbench.reference.linear import check


class PoolCaller:
    #: the launch kind (as the program's launch wrappers name it) that a
    #: unit's search needs: the roofline of that kind reads ``need``
    kernel = "seg_search"

    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self._truth: dict = {}
        self.pool = None
        self.inputs = None
        self.workers = default_workers()     # processes making the pool

    def make_pool(self) -> None:
        """The traffic's ``pool`` histories of the configuration, the
        configuration's ``invalid_share`` of them INVALID."""
        self.pool = single_pool(self.cell.config, self.traffic["pool"],
                                self.seed, self.workers)
        self._ops = [sum(1 for e in it.history if e[1] == "invoke")
                     for it in self.pool]

    @property
    def least_calls(self) -> int:
        """A window checks every history of the pool at least once."""
        return len(self.pool)

    def units(self, j: int) -> list:
        """Call ``j`` checks history ``j mod pool``."""
        return [(j % len(self.pool),)]

    def history(self, unit) -> list:
        return self.pool[unit[0]].history

    def mutated(self, unit) -> bool:
        return self.pool[unit[0]].mutated

    def ops(self, j: int) -> int:
        return self._ops[j % len(self.pool)]

    def warm_up(self) -> None:
        """One INVALID and one VALID history: the search, the
        counterexample's re-scan and replay."""
        mutated = [it.mutated for it in self.pool]
        for i in (mutated.index(True), mutated.index(False)):
            self.call(i)

    def sample(self, calls, rng, full: bool) -> list:
        """The units the reference checks: every unit the window's calls
        answered for when ``full``; else every mutated one of them, and
        then units drawn with ``rng``, up to the traffic's
        ``reference_sample`` units in all."""
        used = sorted({u for c in calls for u in c.answers})
        if full:
            return used
        bad = [u for u in used if self.mutated(u)]
        good = [u for u in used if not self.mutated(u)]
        n = max(self.traffic["reference_sample"] - len(bad), 0)
        return bad + rng.sample(good, min(n, len(good)))

    def truth(self, unit):
        """The plain reference's verdict on ``unit``."""
        if unit not in self._truth:
            self._truth[unit] = check(self.history(unit))
        return self._truth[unit]

    def need(self, unit) -> dict:
        """``{launch kind: (operations, bytes)}`` that ``unit``'s search
        needs at the least, from the reference's own search."""
        return {self.kernel: roofline.need([self.truth(unit)])}

    def release(self) -> None:
        """Drop the program's inputs, so the reference runs beside
        nothing of the program's."""
        self.inputs = None
