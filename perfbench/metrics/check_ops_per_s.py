"""``check_ops_per_s``: operations checked (invocations; a pending one
counts once) by the window's calls that returned, over the window's
time on the host's clock."""


def read(ctx):
    return ctx.kops * 1e3 / ctx.window_s
