"""Info bits decoded per second: k times every block of the window over
the window's seconds (host clock, from the first chunk's call to the last
one's return, which ends in ``sim_ber``'s synchronisation)."""


def read(ctx):
    return ctx.k * ctx.blocks / ctx.window_s
