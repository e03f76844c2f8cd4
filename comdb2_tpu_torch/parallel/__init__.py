"""Deprecated shim — this grew into :mod:`comdb2_tpu_torch.service`.

The mesh helpers live in :mod:`comdb2_tpu_torch.service.sharding`;
import from there. This module re-exports them, as the JAX package's
``parallel`` does.
"""

from __future__ import annotations

import warnings

from ..service.sharding import (check_histories_sharded,  # noqa: F401
                                make_mesh)

warnings.warn(
    "comdb2_tpu_torch.parallel moved to comdb2_tpu_torch.service.sharding; "
    "import from there", DeprecationWarning, stacklevel=2)

__all__ = ["make_mesh", "check_histories_sharded"]
