"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There
is no silent switch: asking for (or defaulting to) ``cuda`` on a host
without a card raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


def on_device(device):
    """A context that makes ``device`` the current CUDA device (a
    launch through a loaded library runs on the current device and
    that device's current stream); a no-op for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def upload(array, device) -> torch.Tensor:
    """A NumPy array as a tensor on ``device``; to a card, through pinned
    memory and a non-blocking copy, so the host does not wait for work
    queued ahead of it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def readback_async(t: torch.Tensor):
    """Queue the copy of ``t`` to the host and return a zero-argument
    ``finalize()`` giving it as a NumPy array. On the card: a
    non-blocking copy into pinned memory on ``t``'s device's current
    stream, then an event; ``finalize`` waits on that event alone, so
    nothing between the two synchronises the host with the card. On the
    CPU: ``t`` itself. ``finalize.ready()`` says, without waiting,
    whether ``finalize`` would return at once (it polls the event)."""
    if not t.is_cuda:
        def finalize():
            return t.numpy()

        finalize.ready = lambda: True
        return finalize
    with torch.cuda.device(t.device):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()

    def finalize():
        ev.synchronize()
        return host.numpy()

    finalize.ready = ev.query
    return finalize


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
