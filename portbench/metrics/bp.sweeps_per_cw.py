"""The sweeps a BP codeword ran, on average over the codewords of every BP
launch of the profiled slice: the program's device counter ``sweeps.bp``
(the kernel's per-codeword sweeps, summed on the card) over its items, as
``polar_torch.utils.tracing.summary()`` reads them. None where the program
has no spans or no such counter, or the slice ran no BP decode."""


def read(ctx):
    try:
        from polar_torch.utils import tracing
    except ImportError:         # a program without spans
        return None
    s = tracing.summary()
    if s is None:
        return None
    c = s.get("device_counters", {}).get("sweeps.bp")
    if not c or not c["items"]:
        return None
    return c["sum"] / c["items"]
