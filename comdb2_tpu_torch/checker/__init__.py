"""Linearizability checking.

- :mod:`.linear_host` — host reference implementation of just-in-time
  linearization over a memoized model (``knossos/linear.clj``).
- :mod:`.linear_torch` — the segment stream the device search consumes.
- :mod:`.seg_kernel` — the segment-search kernel (CUDA) and its plain
  PyTorch version.
- :mod:`.linear` — the :func:`analysis` entry point
  (``linear.clj:299``).
"""

from .linear import Analysis, EngineNotPorted, analysis

__all__ = ["Analysis", "EngineNotPorted", "analysis"]
