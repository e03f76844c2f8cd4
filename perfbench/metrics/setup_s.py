"""``setup_s``: process start to the window's first call: torch import,
CUDA context, loading (on a checkout's first run, building) the kernel
libraries, the pool, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
