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


def queued_ms(fn, reps: int) -> float:
    """Mean card milliseconds per call of ``fn`` (which launches work on
    the current stream): one warm-up call, then a sleep kernel (400k
    cycles, about 0.2 ms, per call) that keeps the card busy while the
    host queues ``reps`` calls behind it, so that the host's time per
    call (Python, allocation, launch) does not show as card time; CUDA
    events around the queued calls."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 400_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
