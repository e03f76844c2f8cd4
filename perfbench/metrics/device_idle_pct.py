"""``device_idle_pct``: the share of the device trace's slice in which
no kernel, copy or set ran on the card, from ``torch.profiler``'s device
activity."""


def read(ctx):
    busy = ctx.busy_s
    return 100.0 * (1.0 - busy / ctx.slice_s) if busy else None
