"""Counterexample minimization (delta debugging as a device workload).

The counterpart of the JAX package's ``shrink`` package.
``minimize(history, checker=...)`` takes an INVALID history and returns
a 1-minimal sub-history: removing any remaining invoke/complete pair
(linearizability axis) or transaction (txn axis) yields VALID or
UNKNOWN. Each ddmin round's candidate set is generated as columnar row
slices of one packed parent and verdict-tested in ONE launch per pow2
shape bucket (on the card: the segment-search kernel's stream mode for
the linear axis, the bf16 closure for the txn axis; ``docs/shrink.md``).

Surfaces: this API and ``python -m comdb2_tpu_torch.filetest --shrink``
(store artifacts: ``minimal.edn``, ``results.edn`` and the re-rendered
``shrink.svg``).
"""

from .core import (DdminEngine, SeedVerdictError, ShrinkResult,
                   Shrinker, atoms_of, minimize)
from .txn import TxnShrinker
from .verdicts import check_candidate, check_candidates

__all__ = ["DdminEngine", "SeedVerdictError", "ShrinkResult",
           "Shrinker", "TxnShrinker", "atoms_of", "check_candidate",
           "check_candidates", "minimize"]
