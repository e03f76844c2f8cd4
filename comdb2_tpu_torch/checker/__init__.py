"""Linearizability checking.

- :mod:`.linear_host` — host reference implementation of just-in-time
  linearization over a memoized model (``knossos/linear.clj``).
- :mod:`.linear_torch` — the segment stream and the torch-op engines:
  seg2 (capacity ladder), big-only seg, per-op (and its batched vmap
  form), keys and flat.
- :mod:`.brute` — the exhaustive oracle for tiny histories.
- :mod:`.seg_kernel` — the segment-search kernel (CUDA; single-history
  and RESET stream modes) and its plain PyTorch version.
- :mod:`.pair_sort` — the per-row pair sort (CUDA) of the keys engine's
  dedup, and its plain PyTorch version.
- :mod:`.mxu` — the MXU frontier engine for wide P.
- :mod:`.linear` — the :func:`analysis` entry point and its engine
  ladder (``linear.clj:299``).
- :mod:`.batch` — :func:`~.batch.check_batch`, many histories per
  launch.
- :mod:`.checkers` — the Jepsen checker objects (``compose``,
  ``Linearizable``, ``Serializable``, set / queue / counter checkers);
  :mod:`.independent` lifts one over keyed histories through
  ``check_batch``; :mod:`.workloads` holds the bank / dirty-reads / G2
  checkers, the host oracles of :mod:`.wl`, the device workload
  families.
- :mod:`.wgl` — the host world search (``knossos/core.clj``).
"""

from .linear import Analysis, analysis
from .checkers import (Checker, check_safe, compose, merge_valid,
                       linearizable, Linearizable, serializable,
                       Serializable, unbridled_optimism,
                       queue, set_checker, total_queue, counter)
from . import independent, workloads, wgl

__all__ = ["Analysis", "analysis", "Checker",
           "check_safe", "compose", "merge_valid", "linearizable",
           "Linearizable", "serializable", "Serializable",
           "unbridled_optimism", "queue", "set_checker", "total_queue",
           "counter", "independent", "workloads", "wgl"]
