"""The controls: the plain reference put in the program's place with one
guarantee of the configuration broken. A run judged on a control's
answers has to come out not correct.

- ``unindexed``: the exact verdict without the failing completion's
  index or its counterexample, as a checker that skipped the
  counterexample would give;
- ``unreported``: the exact verdict and index, without the
  counterexample's configs and paths.
"""

from __future__ import annotations

from .linear import check


def unindexed(history) -> tuple:
    v = check(history)
    return (True, None, None) if v.valid else (False, None, ([], []))


def unreported(history) -> tuple:
    v = check(history)
    return (True, None, None) if v.valid else (False, v.op_index, ([], []))


CONTROLS = {"unindexed": unindexed, "unreported": unreported}
