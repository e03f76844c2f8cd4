"""``kernel_card_ms_per_kop``: the card's ms in the program's
hand-written kernels, from the CUDA events its launch wrappers record
(``compile_guard.time_launches`` / ``card_ms``), per thousand operations
checked."""


def read(ctx):
    return ctx.card_ms / ctx.kops if ctx.card_ms and ctx.kops else None
