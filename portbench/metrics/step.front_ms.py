"""Mean ms a batch between the CUDA events around ``model.front`` (source,
encoder, mapper, AWGN, demapper). Batches of the profiled slice are left
out."""


def read(ctx):
    if not ctx.front_ms:
        return None
    return sum(ctx.front_ms) / len(ctx.front_ms)
