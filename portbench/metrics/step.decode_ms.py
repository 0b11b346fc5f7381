"""Mean ms a batch between the CUDA events around ``model.decoder(llr)``.
Batches of the profiled slice are left out."""


def read(ctx):
    if not ctx.decode_ms:
        return None
    return sum(ctx.decode_ms) / len(ctx.decode_ms)
