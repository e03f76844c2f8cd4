"""``device_idle_pct``: the share of the window in which no kernel, copy
or set ran on the card, from ``torch.profiler``'s device activity; where
the trace holds none, from the CUDA events around the kernel launches."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s(ctx.w0, ctx.w1)
    if busy <= 0:
        if not ctx.card_ms:
            return None
        busy = ctx.card_ms / 1e3
    return 100.0 * (1.0 - busy / ctx.window_s)
