"""comdb2_tpu_torch — the PyTorch/CUDA port of ``comdb2_tpu``.

The single-history linearizability check runs end to end here: EDN
history → :mod:`.ops` pack → :mod:`.models.memo` successor table →
:func:`.checker.linear_torch.make_segments` + ``remap_slots`` → the
segment-search kernel (:mod:`.checker.seg_kernel`, CUDA C++ for
``sm_90a`` in :mod:`.kernels`) → verdict (:func:`.checker.analysis`).

The package imports ``torch`` and numpy only; it never imports ``jax``
or the JAX package. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version instead.
"""

__all__ = ["checker", "models", "ops"]
