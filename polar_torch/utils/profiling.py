"""Complexity accounting: closed-form element-op counts of one SC, SCL or
BP decode, and the one-line meter the CLI prints per decoder."""

from dataclasses import asdict, dataclass

import numpy as np

from polar_torch.models.polar.cuda_scl import _ctz, _cto
from polar_torch.models.polar.scan_core import fast_schedule


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
