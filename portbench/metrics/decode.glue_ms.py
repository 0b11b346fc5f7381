"""Device ms a batch inside the program's ``chain.decode`` span outside its
``kernel.*`` spans: the decoder's torch code (casts, transforms, gathers,
rate recovery, CRC), from the spans' CUDA events over the profiled
slice's batches but its first (``polar_torch.utils.tracing.summary``).
None where the program has no spans or the session recorded no CUDA
event."""


def read(ctx):
    try:
        from polar_torch.utils import tracing
    except ImportError:         # a program without spans
        return None
    s = tracing.summary()
    if s is None or not s["events"]:
        return None
    return s["decode_glue_ms"]
