"""Share of the window's time, in %, in which no operation (kernel, copy
or set) runs on the card: one less the device's busy time a batch (the
union of the operations' intervals over the profiled slice, over its
batches) over the window's own mean batch period on the host clock. The
profiler slows the host's launches, not the device's operations, so only
the busy time is taken from the profile: on a cell that the launches pace
the slice's own idle share reads far above the window's."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.batches or not ctx.batch_period_s:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.batches / ctx.batch_period_s)
