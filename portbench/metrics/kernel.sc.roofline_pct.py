"""The SC subtree kernel's share of its roofline, in %: the least time of
one whole SC decode of a batch (the n LLRs read and the k decisions
written once, the f, g and partial-sum operations of the rate-0-pruned
tree, as the configuration's reference counts them, on
``portbench.work``'s data-sheet rates) over the profiled device time a
batch of the kernels whose names hold ``sc_subtree_kernel``, which the
SCL kernel's ``scl_subtree_kernel`` does not."""

import sys

from portbench import reference, work

KERNELS = ("sc_subtree_kernel",)


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.batches:
        return None
    busy = sl.op_seconds(lambda name: any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    n_bytes, n_ops = reference.link(ctx.cfg, "cpu").decode_work(
        int(ctx.traffic["batch_size"]))
    bound, kind = work.bound_ms(n_bytes, n_ops)
    per_batch_ms = 1e3 * busy / sl.batches
    print(f"kernel.sc.roofline_pct: bound {bound:.6f} ms ({kind}) over "
          f"{per_batch_ms:.6f} ms a batch; card {ctx.power_limit}",
          file=sys.stderr)
    return 100.0 * bound / per_batch_ms
