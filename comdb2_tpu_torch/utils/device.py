"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There
is no silent switch: asking for (or defaulting to) ``cuda`` on a host
without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device on a host without CUDA
    raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
