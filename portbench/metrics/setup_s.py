"""Seconds from the process's start to the window's first batch: imports,
the card, the kernels' build or load, the code's construction and the
warm-up chunks."""


def read(ctx):
    return ctx.setup_s
