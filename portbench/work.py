"""The least work of one whole list decode, and the least time it takes on
the card: a frozen copy of the program's kernel-work counts
(``polar_torch/utils/kernel_work.py``: ``subtree_work``'s per-op counts and
``bound_ms`` with the data-sheet rates), applied to the whole code tree as
one unit. It reads only the decode's sizes and schedule, never the
program's kernels, so it counts the same work whatever implements it.
"""

# f32 operations per element, as the kernel-work counts spend them
OPS_F = {"minsum": 8, "exact": 20}   # clip x2, |.|, min, sign product
OPS_G, OPS_SOFTPLUS, OPS_XOR = 2, 6, 1

# NVIDIA H100 SXM data sheet: HBM bandwidth and the fp32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _ctz(i):
    return (i & -i).bit_length() - 1


def _cto(i):
    c = 0
    while i & 1:
        c += 1
        i >>= 1
    return c


def decode_work(ops, n, k, L, bs, mode):
    """(bytes, f32 operations) a list decode of ``bs`` codewords of length
    ``n`` must at least move and do: the n LLRs of each codeword read once
    (f32) and its k decisions written once (f32); the f/g, softplus,
    partial-sum and top-L work of the node schedule ``ops`` ((kind, stage,
    first leaf), kinds rate0/rep/rate1/frozen/info/pc) over L paths. A PC
    leaf counts as a frozen one (one softplus, no fork)."""
    S = n.bit_length() - 1
    n_bytes = 4 * n * bs + 4 * k * bs
    n_f = n_g = n_sp = n_xor = n_cmp = 0
    for kind, s_nd, lo in ops:
        top = S if lo == 0 else _ctz(lo)
        if lo:
            n_g += 1 << top
        n_f += sum(1 << (s - 1) for s in range(s_nd + 1, top + 1))
        wn = 1 << s_nd
        if kind in ("rate0", "frozen", "pc"):
            n_sp += wn
        elif kind in ("rep", "info"):
            n_sp += 2 * wn
            n_cmp += 2 * L * L
        elif kind == "rate1":
            theta = min(L - 1, wn)
            n_sp += wn
            n_cmp += theta * (2 * L * L + (wn if wn > L - 1 else 0))
        else:
            raise ValueError(f"unknown node kind {kind!r}")
        n_xor += sum(1 << s for s in range(s_nd, min(_cto(lo + wn - 1), S)))
    per_path = OPS_F[mode] * n_f + OPS_G * n_g + OPS_SOFTPLUS * n_sp + \
        OPS_XOR * n_xor
    return n_bytes, L * bs * per_path + bs * n_cmp


def bound_ms(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") of work that moves
    ``n_bytes`` and does ``n_ops`` f32 operations at the data-sheet rates."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * n_ops / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")
