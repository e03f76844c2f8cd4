"""Linearizability checking.

- :mod:`.linear_host` — host reference implementation of just-in-time
  linearization over a memoized model (``knossos/linear.clj``).
- :mod:`.linear_torch` — the segment stream, the seg2 capacity engine
  and the keys engine (torch ops).
- :mod:`.seg_kernel` — the segment-search kernel (CUDA; single-history
  and RESET stream modes) and its plain PyTorch version.
- :mod:`.pair_sort` — the per-row pair sort (CUDA) of the keys engine's
  dedup, and its plain PyTorch version.
- :mod:`.mxu` — the MXU frontier engine for wide P.
- :mod:`.linear` — the :func:`analysis` entry point and its engine
  ladder (``linear.clj:299``).
- :mod:`.batch` — :func:`~.batch.check_batch`, many histories per
  launch.
"""

from .linear import Analysis, EngineNotPorted, analysis

__all__ = ["Analysis", "EngineNotPorted", "analysis"]
