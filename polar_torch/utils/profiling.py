"""Complexity accounting and profiling tools: closed-form element-op
counts of one SC, SCL or BP decode and the one-line meter the CLI prints
per decoder; ``trace``, a ``torch.profiler`` trace of a block of code;
``flop_estimate``, the operations of one call counted as XLA's cost
analysis counts them; and ``cuda_ms``, a call's mean device time on the
card."""

import contextlib
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from polar_torch.models.polar.cuda_scl import _ctz, _cto
from polar_torch.models.polar.scan_core import fast_schedule
from polar_torch.utils import kernel_work


@dataclass
class DecodeComplexity:
    """Element-op counts for one decode call (per batch element)."""
    n: int
    k: int
    list_size: int
    f_ops: int        # check-node LLR updates (elements)
    g_ops: int        # variable-node LLR updates (elements)
    xor_ops: int      # partial-sum combines (elements)
    pm_ops: int       # path-metric softplus updates (elements)
    sort_ops: int     # top-2L selections

    def total(self) -> int:
        return self.f_ops + self.g_ops + self.xor_ops + self.pm_ops

    def as_dict(self):
        d = asdict(self)
        d["total"] = self.total()
        return d


def decode_complexity(n: int, k: int, list_size: int = 1,
                      frozen_mask=None, fast: bool = False,
                      rate1: bool = False) -> DecodeComplexity:
    """Closed-form op counts of one SC/SCL decode.

    Plain schedule: each of the ``log2(n)`` stages processes ``n/2``
    f-elements and ``n/2`` g-elements per path; every frozen leaf costs one
    PM softplus per path, every info leaf two (both fork polarities) plus
    one top-2L selection.

    ``fast=True`` (needs ``frozen_mask``) counts the Hashemi
    rate-0/repetition pruned schedule of ``use_fast_scl=True``, with
    rate-1/SPC nodes under ``rate1``: descent and rise below pruned node
    roots vanish, rate-0 nodes cost one softplus per element, repetition
    nodes one two-candidate fork.
    """
    S = int(np.log2(n))
    L = int(list_size)
    if not fast:
        half = (n // 2) * S
        return DecodeComplexity(
            n=n, k=k, list_size=L,
            f_ops=half * L, g_ops=half * L, xor_ops=half * L,
            pm_ops=(n + k) * L, sort_ops=k if L > 1 else 0)
    if frozen_mask is None:
        raise ValueError("fast complexity needs the frozen mask")
    f_ops = g_ops = xor_ops = pm_ops = sort_ops = 0
    for kind, s_nd, lo in fast_schedule(frozen_mask, rate1=rate1):
        d = S if lo == 0 else _ctz(lo)
        if lo != 0:
            g_ops += 1 << d
        f_ops += (1 << d) - (1 << s_nd)     # sum 2^(d-1)..2^s_nd
        i_end = lo + (1 << s_nd) - 1
        r = _cto(i_end)
        xor_ops += (1 << min(r, S)) - (1 << s_nd)
        if kind == "z":
            pm_ops += 1 << s_nd
        elif kind == "f":
            pm_ops += 1
        elif kind in ("o", "s"):
            # rate-1 / SPC node: base softplus per element, theta
            # iterative-min extraction sweeps + one-hot flip applies, and
            # theta (minus one for SPC's parity-forced position)
            # two-candidate forks
            w = 1 << s_nd
            theta = (min(list_size - 1, w) if kind == "o"
                     else min(list_size, w))
            forks = theta if kind == "o" else theta - 1
            srt = theta if (kind == "s" or w > list_size - 1) else 0
            pm_ops += w + srt * w
            xor_ops += (forks + (1 if kind == "s" else 0)) * w
            sort_ops += forks
        else:
            pm_ops += 2 * (1 << s_nd)       # both polarities
            sort_ops += 1
    return DecodeComplexity(
        n=n, k=k, list_size=L,
        f_ops=f_ops * L, g_ops=g_ops * L, xor_ops=xor_ops * L,
        pm_ops=pm_ops * L, sort_ops=sort_ops if L > 1 else 0)


def bp_complexity(n: int, k: int, num_iter: int) -> DecodeComplexity:
    """Closed-form op counts of one BP decode (worst case, no early stop).

    Each iteration runs two sweeps of ``log2(n)`` stages; every stage
    evaluates four boxplus calls over ``n/2`` elements (2n f-ops) plus the
    same volume of adds (counted as g-ops).
    """
    S = int(np.log2(n))
    per_iter = 2 * S * 2 * n
    return DecodeComplexity(
        n=n, k=k, list_size=1,
        f_ops=per_iter * num_iter, g_ops=per_iter * num_iter,
        xor_ops=0, pm_ops=0, sort_ops=0)


def complexity_line(name: str, comp: DecodeComplexity) -> str:
    """One-line ops meter for CLI output."""
    return (f"# complexity {name}: {comp.total():,} element-ops/block "
            f"({comp.total() / max(comp.k, 1):.1f} ops/info bit, "
            f"n={comp.n} k={comp.k} L={comp.list_size})")


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"): run()`` writes a ``torch.profiler`` trace
    of the block into ``log_dir`` (TensorBoard's profiler plugin and
    ``chrome://tracing`` read it): host activity, and the card's kernels
    and copies when a card is present. The program's spans
    (``utils.tracing``: ``sim.step``, ``chain.front``, ``scl.sweep``,
    ``kernel.scl_subtree`` and the rest) appear in it beside the kernels
    they launched, on the profiler's clock, and ``tracing.summary()``
    reads the same block's spans afterwards. Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()    # the block's kernels end inside


# XLA's cost analysis counts one operation per output element of an
# arithmetic, comparison or select op (a cast included) and none for a
# transcendental (exp, log, tanh, sqrt, pow, ...); these aten ops are the
# former (in-place and out= forms by the same name)
_ELEMENTWISE = frozenset("""
    add sub rsub mul div neg abs maximum minimum fmax fmin clamp clamp_min
    clamp_max where sign eq ne lt le gt ge bitwise_and bitwise_or bitwise_xor
    bitwise_not logical_and logical_or logical_xor logical_not remainder fmod
    floor ceil round trunc masked_fill
""".split())
# reductions: one operation per input element less one per output element
_REDUCTIONS = frozenset("sum mean amax amin max min prod any all".split())


def _aten_flops(func, args, kwargs, out) -> int:
    """XLA-convention operations of one aten call."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    name = packet.__name__.rstrip("_")
    if name == "mv":
        return 2 * args[0].numel()
    if name == "dot":
        return 2 * args[0].numel()
    first = out[0] if isinstance(out, (tuple, list)) and out else out
    if not isinstance(first, torch.Tensor):
        return 0
    if name in _ELEMENTWISE:
        return first.numel()
    if name in _REDUCTIONS and isinstance(args[0], torch.Tensor):
        return args[0].numel() - first.numel()
    if (name == "_to_copy" and isinstance(args[0], torch.Tensor)
            and first.dtype != args[0].dtype):
        return first.numel()
    return 0


class _FlopCount(TorchDispatchMode):
    """Counts ``_aten_flops`` of every aten call it sees, and (through
    ``kernel_work``) the work of every hand-written kernel launched while
    it runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flops += _aten_flops(func, args, kwargs, out)
        return out


def flop_estimate(fn, *args) -> float:
    """Operations of one call ``fn(*args)``, counted as the JAX package's
    ``flop_estimate`` (XLA's cost analysis) counts them: 2 M N K per
    matrix product, one per output element of an arithmetic elementwise
    op, none for transcendentals. The call runs once. A hand-written
    kernel adds its launch's f32 operations (``kernel_work``; BP counts
    every sweep, whatever stops early)."""
    est = _FlopCount()
    kernel_work._estimates.append(est)
    try:
        with est:
            fn(*args)
    finally:
        kernel_work._estimates.remove(est)
    return float(est.flops)


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
