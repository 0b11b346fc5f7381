"""Device operations a batch inside the program's ``chain.decode`` span
(the decoder's call): the aten ops that launch device work plus the
hand-written kernels' launches, counted in the first batch of the tracing
session that the profiled slice leaves
(``polar_torch.utils.tracing.summary``). None where the program has no
spans or the session recorded no CUDA event."""


def read(ctx):
    try:
        from polar_torch.utils import tracing
    except ImportError:         # a program without spans
        return None
    s = tracing.summary()
    if s is None or not s["events"]:
        return None
    return s["decode_ops"]
