"""The BP kernel's share of its roofline, in %: the least time of one whole
BP decode of a batch (the n LLRs read and the k decisions written once,
the per-element and per-check operations at the mean sweeps that the
configuration's reference runs at the traffic's Eb/N0, as the reference
counts them, on ``portbench.work``'s data-sheet rates) over the profiled
device time a batch of the kernels whose names hold ``bp_kernel``."""

import sys

import torch

from portbench import compare, reference, work

KERNELS = ("bp_kernel",)


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.batches:
        return None
    busy = sl.op_seconds(lambda name: any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    link = reference.link(ctx.cfg, dev)
    ebno = compare.ebno_db(ctx.traffic)
    n_bytes, n_ops = link.decode_work(int(ctx.traffic["batch_size"]), ebno)
    bound, kind = work.bound_ms(n_bytes, n_ops)
    per_batch_ms = 1e3 * busy / sl.batches
    print(f"kernel.bp.roofline_pct: bound {bound:.6f} ms ({kind}) over "
          f"{per_batch_ms:.6f} ms a batch; card {ctx.power_limit}",
          file=sys.stderr)
    return 100.0 * bound / per_batch_ms
