"""Caller ``independent``: a closed loop of one caller over a pool of
``jepsen.independent`` tests, each handed whole to
``checker.independent.checker(Linearizable(device=...))``.

The traffic file gives ``pool`` (tests, made from the seed in set-up;
the configuration's ``invalid_share`` of them INVALID), ``key`` (every
value of a test's history goes under it as ``(key, v)``, as jepsen's
``independent/tuple`` puts it) and ``reference_sample`` (as for
``analysis``). Call ``j`` checks test ``j mod pool``. Set-up warms up
with one INVALID and one VALID test. The harness reads
``whole_passes``, ``trace_calls`` and ``trace_start``.

The answer is the key's: its verdict, where the checker's own verdict
for the test and its ``failures`` agree with it (an answer that matches
nothing where they do not), the failing op's index mapped from the key's
subhistory to the test's history, which the plain reference checks with
the values unwrapped, and the key's counterexample.
"""

from __future__ import annotations

from perfbench.lib.caller import PoolCaller
from perfbench.lib.harness import answer


class Caller(PoolCaller):

    def setup(self) -> None:
        from comdb2_tpu_torch.checker import independent
        from comdb2_tpu_torch.checker.checkers import Linearizable
        from comdb2_tpu_torch.models.model import cas_register
        from comdb2_tpu_torch.ops.op import Op

        key = self.traffic["key"]
        self._key, self._model = key, cas_register
        self._checker = independent.checker(
            Linearizable(device=self.device))
        if self.pool is None:
            self.make_pool()
        self.inputs = [[Op(p, t, f, independent.tuple_(key, v))
                        for p, t, f, v in it.history] for it in self.pool]
        # the key's subhistory holds its own ops and every un-keyed one
        self._where = [[n for n, op in enumerate(h)
                        if not independent.is_tuple(op.value)
                        or op.value.key == key] for h in self.inputs]
        self.warm_up()

    def call(self, j: int):
        (i,), = self.units(j)
        r = self._checker.check({}, self._model(), self.inputs[i])
        res = r["results"][self._key]
        if "error" in res:                # the checker raised inside
            raise RuntimeError(res["error"].strip().splitlines()[-1])
        valid = res["valid?"]
        if r["valid?"] != valid or \
                (self._key in r["failures"]) != (valid is False):
            valid = None                  # the lift disagrees with the key
        at = res.get("op-index")
        return self.ops(j), {(i,): answer(
            valid, None if at is None else self._where[i][at],
            res.get("configs"), res.get("paths"))}
