"""Host ms a batch in the program's ``sim.step`` span outside
``chain.front``, ``chain.decode`` and the blocking wait in ``sim.sync``:
``sim_ber``'s own work (the generator's seeding, the counting ops' launch,
its bookkeeping), which the card idles on between batches, over the
profiled slice's batches but its first
(``polar_torch.utils.tracing.summary``). Read inside the profiled slice,
so the profiler's cost a host op inflates it, alike on both sides of a
comparison. None where the program has no spans or the session recorded
no CUDA event."""


def read(ctx):
    try:
        from polar_torch.utils import tracing
    except ImportError:         # a program without spans
        return None
    s = tracing.summary()
    if s is None or not s["events"]:
        return None
    return s["harness_host_ms"]
