"""Caller ``analysis``: a closed loop of one caller over a pool of
single histories, each handed whole to ``checker.linear.analysis`` on
the card.

The traffic file gives ``pool`` (histories, made from the seed in
set-up; the configuration's ``invalid_share`` of them INVALID) and
``reference_sample`` (how many of the histories that the window checked
the plain reference checks again, every INVALID one among them). Call
``j`` checks history ``j mod pool``. Set-up warms up with one INVALID and
one VALID history.
"""

from __future__ import annotations

from perfbench.lib.caller import PoolCaller
from perfbench.lib.harness import answer


class Caller(PoolCaller):

    def setup(self) -> None:
        from comdb2_tpu_torch.checker.linear import analysis
        from comdb2_tpu_torch.models.model import cas_register
        from comdb2_tpu_torch.ops.op import Op

        self._analysis, self._model = analysis, cas_register
        if self.pool is None:
            self.make_pool()
        self.inputs = [[Op(*e) for e in it.history] for it in self.pool]
        self.warm_up()

    def call(self, j: int):
        (i,), = self.units(j)
        a = self._analysis(self._model(), self.inputs[i],
                           device=self.device)
        return self.ops(j), {(i,): answer(a.valid, a.op_index, a.configs,
                                          a.info.get("paths"))}
