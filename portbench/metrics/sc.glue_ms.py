"""Device ms a batch inside the program's ``sc.sweep`` span outside its
``kernel.sc_subtree`` spans: the SC sweep's torch code (the f and g above
the subtree depth, the casts, the partial-sum combines, the closing
transform), from the spans' CUDA events over the profiled slice's
batches but its first (``polar_torch.utils.tracing.summary``). Also
prints the session's whole span table to standard error, as the SC cell
lists no ``front.ops``. None where the program has no spans, the session
recorded no CUDA event or ran no SC sweep."""

import sys


def read(ctx):
    try:
        from polar_torch.utils import tracing
    except ImportError:         # a program without spans
        return None
    s = tracing.summary()
    if s is None or not s["events"]:
        return None
    spans = s["spans"]
    sweep = spans.get("sc.sweep", {}).get("device_ms")
    if sweep is None:
        return None
    print(tracing.format_table(s), file=sys.stderr)
    return sweep - (spans.get("kernel.sc_subtree", {}).get("device_ms")
                    or 0.0)
