"""Device meshes and the shard-placement axis of the serving layer.

The counterpart of the JAX package's ``service/sharding.py``. A mesh is
a power-of-two tuple of ``torch.device``s: every bucket dispatch of a
``VerifierCore(shards=D)`` pads its batch axis to a pow2 multiple of D,
and ``check_batch`` / ``closure_diag_batch`` split it over the mesh —
shard d owns rows ``[d*g, (d+1)*g)``, g = B_pad / D, and runs as one
independent launch on its own device, with no collectives. ``shards=1``
(the default) is the single-device path, mesh-free.

``make_mesh(n)`` takes the first n CUDA devices; ``make_mesh(n,
device="cpu")`` gives n CPU slots, so the shard logic runs in tests on
a host without a card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

#: declared ceiling of the shard-placement axis (as in the JAX package)
MAX_SHARDS = 64


def make_mesh(n_devices: Optional[int] = None,
              device=None) -> Tuple[torch.device, ...]:
    """A mesh over the first ``n_devices`` CUDA devices (all by
    default). Asking for more devices than are visible is an error, not
    a silently smaller mesh. ``device="cpu"`` gives ``n_devices`` CPU
    slots (one by default)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * (1 if n_devices is None
                                         else int(n_devices))
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device type {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' for a mesh of CPU "
            "slots")
    n_vis = torch.cuda.device_count()
    if n_devices is not None and n_devices > n_vis:
        raise ValueError(f"requested {n_devices} shards but only {n_vis} "
                         "device(s) are visible")
    n = n_vis if n_devices is None else int(n_devices)
    return tuple(torch.device("cuda", i) for i in range(n))


def shard_fill(n_live: int, b_prog: int, D: int) -> List[float]:
    """Per-shard occupancy of one dispatch: live (non-padding) histories
    land contiguously (shard d owns rows ``[d*g, (d+1)*g)``, g =
    b_prog/D — the ``plan_shard_slices`` layout), so shard d's fill is
    the clamped overlap with the first ``n_live`` rows. Sums to
    ``n_live / g``."""
    g = max(b_prog // max(D, 1), 1)
    return [min(max(n_live - d * g, 0), g) / g for d in range(D)]


def check_histories_sharded(histories, model, mesh=None, F: int = 256):
    """Check many independent histories with the batch axis split over a
    mesh; returns (status, fail_at, n_final) NumPy arrays. Builds the
    mesh over every visible CUDA device when none is given.
    ``check_batch`` pads the batch axis to a pow2 multiple of the mesh
    size with sentinel histories (excluded from the verdicts)."""
    from ..checker.batch import check_batch, pack_batch

    histories = list(histories)
    if not histories:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    mesh = mesh if mesh is not None else make_mesh()
    return check_batch(pack_batch(histories, model), F=F, mesh=mesh)


__all__ = ["MAX_SHARDS", "check_histories_sharded", "make_mesh",
           "shard_fill"]
