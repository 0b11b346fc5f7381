"""The work of the hand-written kernels: the bytes one call must at least
move and the f32 operations it must at least do, from its arguments.

``chip_smoke.py`` turns these counts into each kernel's bound on the card;
``profiling.flop_estimate`` adds the operations of every kernel launch that
runs while it counts, since a kernel called through ``ctypes`` is no
dispatcher op that it could see. Each wrapper reports its launches through
``report``, which costs nothing while no estimate runs. ``launch_counts``
and ``reset_launch_counts`` read and clear the wrappers' launch counts.
"""

# f32 operations per element, as the kernels' routines spend them
OPS_F = {"minsum": 8, "exact": 20}   # clip x2, |.|, min, sign product
OPS_G, OPS_SOFTPLUS, OPS_XOR = 2, 6, 1

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


def launch_counts():
    """Each kernel form's launch count, as its wrapper keeps it. The
    ``scl_subtree`` forms overlap: a traced launch at L=32 counts as
    traced and as wide."""
    from polar_torch.models.polar import cuda_bp, cuda_sc, cuda_scl
    return {"scl_subtree": cuda_scl.scl_subtree.launches,
            "scl_subtree traced": cuda_scl.scl_subtree.launches_traced,
            "scl_subtree wide": cuda_scl.scl_subtree.launches_wide,
            "sc_subtree": cuda_sc.sc_subtree.launches,
            "bp": cuda_bp.bp_decode.launches,
            "bp bf16": cuda_bp.bp_decode.launches_bf16}


def reset_launch_counts():
    """Every kernel wrapper's launch counts to 0."""
    from polar_torch.models.polar import cuda_bp, cuda_sc, cuda_scl
    for name in ("launches", "launches_traced", "launches_wide"):
        setattr(cuda_scl.scl_subtree, name, 0)
    cuda_sc.sc_subtree.launches = 0
    cuda_bp.bp_decode.launches = 0
    cuda_bp.bp_decode.launches_bf16 = 0
