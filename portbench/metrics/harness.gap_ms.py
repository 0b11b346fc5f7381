"""Mean device-clock gap in ms from the CUDA event after one batch's
decoder call to the event before the next batch's ``front``: the
harness's per-batch synchronisation, counters and generator seeding
(``sim.sim_ber``). Batches of the profiled slice are left out."""


def read(ctx):
    if not ctx.gap_ms:
        return None
    return sum(ctx.gap_ms) / len(ctx.gap_ms)
