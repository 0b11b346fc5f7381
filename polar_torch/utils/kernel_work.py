"""The work of the hand-written kernels: the bytes one call must at least
move and the f32 operations it must at least do, from its arguments.

``chip_smoke.py`` turns these counts into each kernel's bound on the card;
``profiling.flop_estimate`` adds the operations of every kernel launch that
runs while it counts, since a kernel called through ``ctypes`` is no
dispatcher op that it could see. Each wrapper reports its launches through
``report``, which costs nothing while no estimate runs. ``launch_counts``
and ``reset_launch_counts`` read and clear the decoder kernels' launch
counts, which the wrappers keep in ``utils.tracing``'s registry (the
probes' are read in ``polar_torch.probes``); ``bound_ms`` turns a count
into the least time on the card.
"""

from polar_torch.utils import tracing

# f32 operations per element, as the kernels' routines spend them
OPS_F = {"minsum": 8, "exact": 20}   # clip x2, |.|, min, sign product
OPS_G, OPS_SOFTPLUS, OPS_XOR = 2, 6, 1

# NVIDIA H100 SXM data sheet: HBM bandwidth and fp32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the probes' operations per element (polar_torch/probes.py)
PROBE_OPS = {"fori": 5, "bcast": 1, "roll": 1, "reduce": 1, "shift": 3,
             "scratchfori": 10, "arith": 5, "gather": 0, "int8": 3}
# the stage sweeps' row groups: stages 0..g-1 pair rows inside groups of
# 2^g rows (k_big's stages 6 and 7 pair the equal tiles of its scratch)
PROBE_GROUP_ROWS = {"sweepcombo": 8, "bigsweep": 64, "bigsweep_noloop": 64}
# one stage update: two |.|, the min, two sign products
OPS_MINSUM = 5

# the running estimates' counters (objects with a ``flops`` attribute)
_estimates = []


def report(work, *args):
    """Add ``work(*args)``'s operations to every running estimate."""
    if _estimates:
        n_ops = work(*args)[1]
        for est in _estimates:
            est.flops += n_ops


def subtree_work(ops, b, mode, a, frz=None):
    """(bytes, f32 operations) one SCL subtree call must at least move and
    do: each input read once (a broadcast input counts once), each output
    written once; the f/g, softplus, partial-sum and top-L work of the
    op schedule over the L paths and bs codewords of ``a``. A traced
    ``'t'`` leaf counts as the frozen or info leaf its flag in ``frz``
    makes it (the kernel skips a frozen leaf's fork); a PC leaf ``'p'``
    as a frozen one (one softplus, no fork)."""
    from polar_torch.models.polar.cuda_scl import _ctz, _cto
    _, L, bs = a.shape
    a_bytes = a.element_size()
    for size, stride in zip(a.shape, a.stride()):
        a_bytes *= size if stride else 1
    w = 1 << b
    n_bytes = (a_bytes + 4 * L * bs + 12 * len(ops)          # a, pm, table
               + 4 * w * L * bs + 4 * L * bs + 4 * L * bs)   # cw, P, pm
    if frz is not None:
        n_bytes += 4 * w
        flags = frz.tolist()
        ops = [(("f" if flags[lo] else "i") if kind == "t" else kind, s, lo)
               for kind, s, lo in ops]
    n_f = n_g = n_sp = n_xor = n_cmp = 0
    for kind, s_nd, lo in ops:
        top = b if lo == 0 else _ctz(lo)
        if lo:
            n_g += 1 << top
        n_f += sum(1 << (s - 1) for s in range(s_nd + 1, top + 1))
        wn = 1 << s_nd
        if kind in ("z", "f", "p"):
            n_sp += wn
        elif kind in ("r", "i"):
            n_sp += 2 * wn
            n_cmp += 2 * L * L
        else:                                   # 'o' / 's' flip forks
            theta = min(L, wn) if kind == "s" else min(L - 1, wn)
            n_sp += wn
            n_cmp += theta * (2 * L * L + (wn if wn > L - 1 else 0))
        n_xor += sum(1 << s for s in range(s_nd, min(_cto(lo + wn - 1), b)))
    per_path = OPS_F[mode] * n_f + OPS_G * n_g + OPS_SOFTPLUS * n_sp + \
        OPS_XOR * n_xor
    return n_bytes, L * bs * per_path + bs * n_cmp


def sc_subtree_work(ops, b, bs, mode):
    """(bytes, f32 operations) one SC subtree call must at least move and
    do: a f32 in and cw int32 out once each, plus the schedule table; the
    f, g and partial-sum xor elements of its schedule over bs codewords (a
    rate-0 node's descent stops one stage above its root)."""
    from polar_torch.models.polar.cuda_scl import _ctz, _cto
    w = 1 << b
    n_bytes = 4 * w * bs + 4 * w * bs + 12 * len(ops)
    n_f = n_g = n_xor = 0
    for kind, s_nd, lo in ops:
        stop = s_nd + 1 if kind == "z" else s_nd
        d = b if lo == 0 else _ctz(lo)
        if lo and d >= stop:
            n_g += 1 << d
        n_f += sum(1 << (s - 1) for s in range(d, stop, -1))
        n_xor += sum(1 << s for s in range(s_nd, min(_cto(lo + (1 << s_nd)
                                                          - 1), b)))
    return n_bytes, bs * (OPS_F[mode] * n_f + OPS_G * n_g + OPS_XOR * n_xor)


def bp_work(n, bs, sweeps, checks, mode, msf):
    """(bytes, f32 operations) BP decodes of ``bs`` codewords must at least
    move and do, having run ``sweeps`` sweeps and ``checks`` G-matrix
    checks in all: the LLRs in and the output back once, the prior and the
    flags; per butterfly and stage two f, the partner sum and the add, and
    in scaled min-sum the two products; per check the two hard decisions
    (an add and a compare per row each), the re-encode's xors and the
    comparison."""
    S = n.bit_length() - 1
    n_bytes = 4 * n * bs + 4 * n * bs + 4 * n + 4 * bs
    scaled = mode == "minsum" and msf != 1.0
    per_sweep = 2 * S * (n // 2) * (2 * OPS_F[mode] + 2 + (2 if scaled
                                                           else 0))
    per_check = 5 * n + OPS_XOR * S * (n // 2)
    return n_bytes, sweeps * per_sweep + checks * per_check


def probe_work(name, x, ptr=None):
    """(bytes, operations) one launch of probe ``name`` on ``x`` (and
    ``k_gather``'s pointers ``ptr``) must at least move and do: ``x`` read
    once (``k_bcast`` reads one 128-column block) and its output written
    once; the f32 (or, for ``int8``, integer) operations of ``PROBE_OPS``
    over the output.

    The stage sweeps need far less than their kernels do. Off NaN inputs
    the two rows of a pair take one value (with a NaN they may differ in
    its bits: ``probes._minsum``), so once the stages that pair rows
    inside a group of ``PROBE_GROUP_ROWS`` rows have run, every row of the
    group holds the same value (in ``k_big``'s scratch, so does that row
    in each of the 16 tiles). The next stage pairs two equal values, which
    gives their |.|, and nothing later changes it. So each group's result
    is its least |x|, whatever the sweeps (``test_torch_probes`` holds the
    plain versions to that): g - 1 min-sum updates and one |.| a group of
    ``x``. The count stands for NaN inputs too."""
    n_out = x.numel() * x.element_size()
    n_in = n_out
    if name == "bcast":
        n_in = x.shape[0] * 128 * x.element_size()
    if ptr is not None:
        n_in += ptr.numel() * ptr.element_size()
    if name in PROBE_GROUP_ROWS:
        g = PROBE_GROUP_ROWS[name]
        return n_in + n_out, x.numel() // g * ((g - 1) * OPS_MINSUM + 1)
    return n_in + n_out, PROBE_OPS[name] * x.numel()


def bound_ms(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") of a call that moves
    ``n_bytes`` and does ``n_ops`` f32 operations, on the card's
    data-sheet rates."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * n_ops / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# each kernel form's key in ``launch_counts`` and its tracing counter
LAUNCH_COUNTERS = {"scl_subtree": "launch.scl_subtree",
                   "scl_subtree traced": "form.scl_subtree.traced",
                   "scl_subtree wide": "form.scl_subtree.wide",
                   "sc_subtree": "launch.sc_subtree",
                   "bp": "launch.bp",
                   "bp bf16": "form.bp.bf16"}


def launch_counts():
    """Each kernel form's launch count, as its wrapper counts it. The
    ``scl_subtree`` forms overlap: a traced launch at L=32 counts as
    traced and as wide."""
    return {key: tracing.counter(name)
            for key, name in LAUNCH_COUNTERS.items()}


def reset_launch_counts():
    """Every kernel wrapper's launch counts to 0."""
    tracing.reset_counters(LAUNCH_COUNTERS.values())
