"""Smoke run of the PyTorch port (``polar_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repo root; one card, nvcc

It drives two paths: the fast-SCL chain (phases 4 and 5) and the CLI sweep
(phase 6). Phases (any failure exits non-zero and prints no result):

1. the card: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every kernel of both paths from ``polar_torch/csrc``,
   one ``nvcc`` per kernel, all started together;
3. kernels against their plain versions on the card, on the same CUDA
   inputs. The
   SCL subtree kernel (``scl_subtree``) against ``scl_subtree_plain`` on a
   5G k=32 n=64 code at b=3, on random masks (rate-1 and SPC nodes), and
   through the whole k=512 n=1024 sweep at the decoder's subtree depth and
   at a smaller one (so the outer sweep runs on the card too). Codewords
   and parent maps must agree on >= 99.8% of blocks, path metrics to
   1e-5 relative on the agreeing blocks. The same holds for the plain
   (unpruned) SCL-8 sweep at k=512 n=1024. The SC subtree kernel
   (``sc_subtree``) against ``sc_subtree_plain``: random masks at
   b = 3..8, static (ops z/f/i) and traced (op t) forms, and the 5G k=512
   n=1024 code at the SC decoder's depth and as the whole tree. Min-sum
   must agree on every block, exact mode on >= 99.9% of blocks;
4. the main path: ``SystemAWGNModel.step`` (source -> 5G k=512 n=1024
   polar encoder -> QPSK -> AWGN -> demapper -> SCL-8 min-sum fast-SCL
   decoder with rate-1 nodes) at a batch of 8192 codewords and 2.0 dB,
   with every kernel's launch count reset just before and read just after;
   prints info bit/s and ms per step;
5. BLER at 1.5 dB over 32768 blocks against the ``scl8_n1024_fast_r1`` row
   of ``benchmarks/bler_validation.json`` (+-0.006, about 4 sigma);
6. the CLI path: ``polar_torch.main.sweep`` at k=512 n=1024 (5G), bs=8192,
   4 batches per point at 1.5 and 2.0 dB: SC on the ``sc_subtree`` kernel,
   then SCL-8 on the plain sweep and the ``scl_subtree`` kernel, with both
   launch counts reset just before and read just after. Gates: SC BLER at
   2.0 dB within +-0.011 of ``sc_n1024``, SCL-8 BLER at 1.5 dB within
   +-0.007 of ``scl8_n1024`` (about 4 sigma of both samples combined);
7. where the time goes: the SC, plain SCL and fast SCL depth surveys,
   kernel, plain and bound times over one decode, and one profiled
   main-path step.

The line before the card's line is one JSON object ``{"kernels": [...]}``
with each kernel's launches on its path (``scl_subtree``: the fast-SCL
chain; ``sc_subtree``: the CLI sweep), its disagreement with the plain
version, and its time, the plain version's time and its bound at the
path's shape. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

K, N, LIST_SIZE, MODE = 512, 1024, 8, "minsum"
BATCH = 8192
EBNO_MAIN_DB = 2.0
EBNO_BLER_DB, BLER_BLOCKS, BLER_TOL = 1.5, 32768, 0.006
SURVEY_DEPTHS = range(5, 11)        # subtree depths b timed at the end
SC_SURVEY_DEPTHS = range(4, 11)
PLAIN_SURVEY_DEPTHS = range(4, 11)  # the plain SCL-8 sweep's depths
BLOCK_AGREEMENT, PM_RTOL = 0.998, 1e-5
SC_EXACT_AGREEMENT = 0.999          # min-sum SC must agree on every block
SC_CHECK_BATCH = 4096
CLI_EBNO_DB, CLI_MC_ITER = (1.5, 2.0), 4
CLI_GATES = (("SC", "sc_n1024", 2.0, 0.011),
             ("SCL-8", "scl8_n1024", 1.5, 0.007))
SEED = 0

# NVIDIA H100 SXM data sheet: HBM bandwidth and fp32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# f32 operations per element, as the kernel's routine spends them
OPS_F = {"minsum": 8, "exact": 20}   # clip x2, |.|, min, sign product
OPS_G, OPS_SOFTPLUS, OPS_XOR = 2, 6, 1


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def subtree_work(ops, b, L, bs, mode, a):
    """(bytes, f32 operations) one subtree call must at least move and do:
    each input read once (a broadcast input counts once), each output
    written once; the f/g, softplus, partial-sum and top-L work of the
    op schedule over L paths and bs codewords."""
    from polar_torch.models.polar.cuda_scl import _ctz, _cto
    a_bytes = a.element_size()
    for size, stride in zip(a.shape, a.stride()):
        a_bytes *= size if stride else 1
    w = 1 << b
    n_bytes = (a_bytes + 4 * L * bs + 12 * len(ops)          # a, pm, table
               + 4 * w * L * bs + 4 * L * bs + 4 * L * bs)   # cw, P, pm
    n_f = n_g = n_sp = n_xor = n_cmp = 0
    for kind, s_nd, lo in ops:
        top = b if lo == 0 else _ctz(lo)
        if lo:
            n_g += 1 << top
        n_f += sum(1 << (s - 1) for s in range(s_nd + 1, top + 1))
        wn = 1 << s_nd
        if kind in ("z", "f"):
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


def bound_ms(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") on the card's data-sheet
    rates."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * n_ops / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


class ScCheck:
    """Accumulates SC kernel-vs-plain comparisons of codewords or
    decisions ([rows, bs] integers); fails on the first miss. Min-sum must
    agree on every block, exact mode on ``SC_EXACT_AGREEMENT``."""

    def __init__(self):
        self.blocks = {"minsum": 0, "exact": 0}
        self.bad = {"minsum": 0, "exact": 0}
        self.max_abs = 0

    def add(self, label, mode, want, got):
        import torch
        diff = (want.to(torch.int32) - got.to(torch.int32)).abs()
        bad = diff.flatten(0, -2).any(0)
        n_bad, n_blocks = int(bad.sum().item()), bad.numel()
        share = 1.0 - n_bad / n_blocks
        log(f"  {label}, {mode}: blocks agree {share:.6f} ({n_bad} of "
            f"{n_blocks} differ)")
        need = 1.0 if mode == "minsum" else SC_EXACT_AGREEMENT
        if share < need:
            raise AssertionError(f"{label}, {mode}: kernel disagrees with "
                                 f"the plain version (share {share})")
        self.blocks[mode] += n_blocks
        self.bad[mode] += n_bad
        self.max_abs = max(self.max_abs, int(diff.max().item()))


def differing(want, got):
    """[bs] mask of the blocks whose codewords or parent maps differ
    between two (cw, P, pm) results."""
    return ((want[0] != got[0]).flatten(0, -2).any(0)
            | (want[1] != got[1]).any(0))


def agreement(want, got):
    """(share of agreeing blocks, max relative and absolute path-metric
    gap on them, differing block count) of two (cw, P, pm) results."""
    pm_w, pm_g = want[2], got[2]
    bad = differing(want, got)
    ok = ~bad
    gap = (pm_w - pm_g).abs()[:, ok]
    rel = gap / pm_w.abs()[:, ok].clamp_min(1e-6)
    return (1.0 - bad.float().mean().item(),
            rel.max().item() if rel.numel() else 0.0,
            gap.max().item() if gap.numel() else 0.0,
            int(bad.sum().item()))


class Check:
    """Accumulates kernel-vs-plain comparisons; fails on the first miss."""

    def __init__(self):
        self.blocks = self.bad = 0
        self.max_abs = self.max_rel = 0.0

    def add(self, label, want, got):
        share, rel, gap, n_bad = agreement(want, got)
        n_blocks = want[2].shape[-1]
        log(f"  {label}: blocks agree {share:.6f} ({n_bad} of {n_blocks} "
            f"differ), pm max rel {rel:.3g}, max abs {gap:.3g}")
        if share < BLOCK_AGREEMENT or rel > PM_RTOL:
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 f"version (share {share}, pm rel {rel})")
        self.blocks += n_blocks
        self.bad += n_bad
        self.max_abs = max(self.max_abs, gap)
        self.max_rel = max(self.max_rel, rel)
        return n_bad


def near_tie_gaps(a, pm, ops, cols, **kw):
    """For blocks ``cols``: the smallest nonzero gap, absolute and relative
    to the block's best path metric, between the L-th and (L+1)-th best
    candidate over the plain version's forks, i.e. how close the block
    came to another decision. (Exact ties, such as the initial clones'
    equal metrics, are broken alike by both versions.)"""
    import torch
    from polar_torch.models.polar import cuda_scl
    gaps = []
    top_l = cuda_scl._top_l

    def recording_top_l(pmc, L):
        srt = torch.sort(pmc, dim=0).values
        gaps.append(srt[L] - srt[L - 1])
        return top_l(pmc, L)

    cuda_scl._top_l = recording_top_l
    try:
        _, _, pm_out = cuda_scl.scl_subtree_plain(a[..., cols], pm[:, cols],
                                                  ops, **kw)
    finally:
        cuda_scl._top_l = top_l
    gap = torch.stack(gaps).abs()
    gap = gap.where(gap > 0, torch.inf).min(0).values
    return [(c, g, g / p) for c, g, p in zip(
        cols, gap.tolist(), pm_out.min(0).values.tolist())]


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    import torch
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


def profile_step(model, gen, top=8):
    """Device time by kernel over one main-path step (torch.profiler), and
    the device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model.step(gen, BATCH, EBNO_MAIN_DB)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.step(gen, BATCH, EBNO_MAIN_DB)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): an operator's entry
    # repeats the time of the kernels it launched
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile: one step {wall_ms:.3f} ms wall (profiled), device busy "
        f"{busy:.3f} ms ({busy / wall_ms:.1%})")
    for ms, key, count in rows[:top]:
        log(f"  {ms:9.3f} ms  {count:4d}x  {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "polar_torch")):
        print("chip_smoke: run from a checkout of the repo (polar_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from polar_torch import _build, from_numpy_state, generate_5g_ranking
    from polar_torch._device import resolve_device
    from polar_torch.config import PolarConfig
    from polar_torch.main import sweep
    from polar_torch.models.polar import cuda_sc, cuda_scl, scan_core
    from polar_torch.models.polar.construction import get_kern_frozen_bits
    from polar_torch.models.polar.cuda_sc import (
        sc_schedule, sc_subtree, sc_subtree_plain, traced_schedule)
    from polar_torch.models.polar.cuda_scl import (
        SubtreeSchedule, scl_subtree, scl_subtree_plain)
    from polar_torch.models.polar.sc import PolarSCDecoder
    from polar_torch.models.polar.scl import PolarSCLDecoder
    from polar_torch.ops.butterfly import polar_transform
    from polar_torch.sim import count_block_errors, count_errors

    # ---- phase 1: the card ----
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: {kind}, {torch.cuda.device_count()} card(s); "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    dev = resolve_device()                      # the current card

    # ---- phase 2: build every kernel of both paths, compilers in parallel
    t0 = time.perf_counter()
    kernels_built = ("scl_subtree", "sc_subtree")
    _build.build([(name, "cuda") for name in kernels_built])
    for name in kernels_built:
        _build.load(name, "cuda")
    log(f"phase 2: built {', '.join(kernels_built)} (nvcc, sm_90a, in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: kernels against their plain versions on the card ----
    log("phase 3: scl_subtree kernel against scl_subtree_plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    check = Check()

    def mask_of(frozen, n):
        mask = np.zeros(n, bool)
        mask[frozen] = True
        return mask

    def random_units(mask, b, L, bs, mode, spc=None):
        units, _ = scan_core.split_fast_schedule(mask, b, rate1=True,
                                                 spc_min_stage=spc)
        for i, u in enumerate(x for x in units if x[0] == "sub"):
            ops = u[2]
            a = 3.0 * torch.randn((1 << b, L, bs), generator=gen, device=dev)
            pm = torch.empty((L, bs), device=dev).exponential_(
                0.5, generator=gen)
            sched = SubtreeSchedule(ops, dev)
            kw = dict(b=b, llr_max=30.0, mode=mode)
            got = scl_subtree(a, pm, sched, **kw)
            want = scl_subtree_plain(a, pm, ops, **kw)
            check.add(f"{len(mask)}-leaf mask, b={b}, L={L}, {mode}, "
                      f"unit {i} ({len(ops)} ops)", want, got)

    random_units(mask_of(generate_5g_ranking(32, 64)[0], 64), 3, 8, 4096,
                 "minsum")
    rng = np.random.default_rng(SEED)
    for L, spc in ((8, 2), (4, None), (2, 3)):
        random_units(rng.random(128) < rng.uniform(0.2, 0.8), 4, L, 2048,
                     "minsum", spc)

    frozen, _ = generate_5g_ranking(K, N)
    state = dict(frozen_pos=frozen, n=N, k=K, list_size=LIST_SIZE,
                 mode=MODE, llr_max=30.0, use_fast_scl=True,
                 fast_rate1=True, spc_min_stage=None)
    model = from_numpy_state(state, device=dev)
    dec = model.decoder
    main_b = dec.lower_stages
    _, _, llr = model.front(gen, BATCH, EBNO_MAIN_DB)
    llr_ch = (-llr).t().contiguous()
    mask = mask_of(frozen, N)

    def plain_subtree(a, pm, sched, **kw):
        return scl_subtree_plain(a, pm, sched.ops, **kw)

    def recorder(calls, subtree):
        def recording(*args, **kw):
            calls.append((args, kw))
            return subtree(*args, **kw)
        return recording

    main_calls = []
    # the decoder's depth, one smaller (more of the sweep outside the
    # kernel) and the whole tree as one call
    for b in (main_b, main_b - 1, N.bit_length() - 1):
        kw = dict(mode=MODE, llr_max=30.0, lower_stages=b, rate1=True)
        u_k, pm_k = scan_core.scl_sweep_hybrid_fast(
            llr_ch, mask, LIST_SIZE,
            subtree=(recorder(main_calls, scl_subtree) if b == main_b
                     else scl_subtree), **kw)
        u_p, pm_p = scan_core.scl_sweep_hybrid_fast(
            llr_ch, mask, LIST_SIZE, subtree=plain_subtree, **kw)
        check.add(f"k={K} n={N} sweep, b={b}, bs={BATCH}",
                  (u_p, torch.zeros_like(pm_p), pm_p),
                  (u_k, torch.zeros_like(pm_k), pm_k))
    for i, ((a, pm, sched), kw) in enumerate(main_calls):
        want = scl_subtree_plain(a, pm, sched.ops, **kw)
        got = scl_subtree(a, pm, sched, **kw)
        if check.add(f"main-path call {i}, b={main_b}, bs={BATCH}", want,
                     got):
            cols = differing(want, got).nonzero().flatten().tolist()
            for col, gap, rel in near_tie_gaps(a, pm, sched.ops, cols, **kw):
                log(f"  differing block {col} of call {i} (seed {SEED}, "
                    f"{EBNO_MAIN_DB} dB): smallest candidate gap {gap:.3g} "
                    f"({rel:.3g} of its best path metric)")

    # the plain (unpruned) SCL-8 sweep of the CLI path, same LLRs
    plain_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                              use_fast_scl=False, device=dev).lower_stages
    plain_calls = []
    kw = dict(mode=MODE, llr_max=30.0, lower_stages=plain_b)
    u_k, pm_k = scan_core.scl_sweep_hybrid(
        llr_ch, mask, LIST_SIZE, subtree=recorder(plain_calls, scl_subtree),
        **kw)
    u_p, pm_p = scan_core.scl_sweep_hybrid(llr_ch, mask, LIST_SIZE,
                                           subtree=plain_subtree, **kw)
    check.add(f"k={K} n={N} plain sweep, b={plain_b}, bs={BATCH}, "
              f"{EBNO_MAIN_DB} dB", (u_p, torch.zeros_like(pm_p), pm_p),
              (u_k, torch.zeros_like(pm_k), pm_k))
    torch.cuda.synchronize()
    log(f"phase 3: scl_subtree: {check.bad} of {check.blocks} blocks "
        f"differ; pm max abs {check.max_abs:.3g}, max rel "
        f"{check.max_rel:.3g}")

    def subtree_times(calls, b, label, reps):
        """Kernel, plain and bound ms over ``calls`` of scl_subtree."""
        k_ms = cuda_ms(lambda: [scl_subtree(*args, **kw)
                                for args, kw in calls], reps=reps)
        p_ms = cuda_ms(lambda: [scl_subtree_plain(a, pm, sched.ops, **kw)
                                for (a, pm, sched), kw in calls], reps=1)
        n_bytes = n_ops = 0
        for (a, _, sched), kw in calls:
            call_bytes, call_ops = subtree_work(sched.ops, b, LIST_SIZE,
                                                BATCH, kw["mode"], a)
            n_bytes += call_bytes
            n_ops += call_ops
        bnd, by = bound_ms(n_bytes, n_ops)
        log(f"  scl_subtree, {len(calls)} calls of {label} (b={b}, "
            f"L={LIST_SIZE}, bs={BATCH}): kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms; bound {bnd:.4f} ms ({by}: {n_bytes} B, "
            f"{n_ops} f32 ops); library: none [{card}]")
        return k_ms, p_ms, bnd, by

    kernel_ms, plain_ms, scl_bound, scl_bound_by = subtree_times(
        main_calls, main_b, "one fast main-path step", reps=3)
    subtree_times(plain_calls, plain_b, "one plain-sweep decode", reps=3)

    log("phase 3: sc_subtree kernel against sc_subtree_plain")
    sc_check = ScCheck()

    def constructed_mask(n):
        """Random rate; frozen by row weight, random order among ties: the
        construction's structure, so info leaves are reliable ones."""
        _, weights, _ = get_kern_frozen_bits(n, 0)
        order = np.lexsort((rng.random(n), weights))
        m = np.zeros(n, bool)
        m[order[:int(rng.uniform(0.2, 0.8) * n)]] = True
        return m

    def codeword_llr(m, bs, sigma):
        """BPSK-over-AWGN channel LLRs of random codewords of mask ``m``."""
        u = torch.randint(0, 2, (len(m), bs), generator=gen, device=dev,
                          dtype=torch.int8)
        u = u * torch.from_numpy(~m).to(dev, torch.int8)[:, None]
        c = polar_transform(u, axis=0).to(torch.float32)
        y = 1.0 - 2.0 * c + sigma * torch.randn(c.shape, generator=gen,
                                                 device=dev)
        return (2.0 * y / sigma ** 2).contiguous()

    # min-sum on uniformly random masks and N(0, 3^2) LLRs; exact mode on
    # constructed masks and codeword LLRs: the exact boxplus loses all
    # precision below ~1e-7 in f32, so an info leaf at an unreliable
    # position would be decided by rounding in either version
    for b in range(3, 9):
        m_rand = rng.random(1 << b) < rng.uniform(0.2, 0.8)
        m_cons = constructed_mask(1 << b)
        for mode, m, a in (
                ("minsum", m_rand, 3.0 * torch.randn(
                    (1 << b, SC_CHECK_BATCH), generator=gen, device=dev)),
                ("exact", m_cons, codeword_llr(m_cons, SC_CHECK_BATCH,
                                               0.8))):
            frz = torch.from_numpy(m.astype(np.int32)).to(dev)
            for form, ops in (
                    ("static", scan_core.fast_schedule(m, rep=False)),
                    ("traced", traced_schedule(b))):
                kw = dict(b=b, llr_max=30.0, mode=mode)
                got = sc_subtree(a, frz, sc_schedule(ops, dev), **kw)
                want = sc_subtree_plain(a, frz, ops, **kw)
                sc_check.add(f"b={b}, {form} ({len(ops)} ops), bs="
                             f"{SC_CHECK_BATCH}", mode, want, got)

    sc_b = PolarSCDecoder(frozen, N, mode=MODE, device=dev).lower_stages

    def plain_sc(a, frz, sched, **kw):
        return sc_subtree_plain(a, frz, sched.ops, **kw)

    sc_calls = []
    for mode in ("minsum", "exact"):
        for b in sorted({sc_b, N.bit_length() - 1}):
            record = mode == MODE and b == sc_b
            u_k = scan_core.sc_sweep_hybrid(
                llr_ch, mask, mode=mode, lower_stages=b,
                subtree=recorder(sc_calls, sc_subtree) if record
                else sc_subtree)
            u_p = scan_core.sc_sweep_hybrid(llr_ch, mask, mode=mode,
                                            lower_stages=b, subtree=plain_sc)
            sc_check.add(f"k={K} n={N} SC sweep, b={b}, bs={BATCH}, "
                         f"{EBNO_MAIN_DB} dB", mode, u_p, u_k)
    torch.cuda.synchronize()
    log(f"phase 3: sc_subtree: min-sum {sc_check.bad['minsum']} of "
        f"{sc_check.blocks['minsum']} blocks differ, exact "
        f"{sc_check.bad['exact']} of {sc_check.blocks['exact']}")

    # SC kernel, plain and bound over the subtree calls of one SC decode
    sc_kernel_ms = cuda_ms(lambda: [sc_subtree(*args, **kw)
                                    for args, kw in sc_calls], reps=5)
    sc_plain_ms = cuda_ms(lambda: [sc_subtree_plain(a, frz, sched.ops, **kw)
                                   for (a, frz, sched), kw in sc_calls],
                          reps=1)
    n_bytes = n_ops = 0
    for (_, _, sched), _ in sc_calls:
        call_bytes, call_ops = sc_subtree_work(sched.ops, sc_b, BATCH, MODE)
        n_bytes += call_bytes
        n_ops += call_ops
    sc_bound, sc_bound_by = bound_ms(n_bytes, n_ops)
    log(f"  sc_subtree, {len(sc_calls)} calls of one SC decode (b={sc_b}, "
        f"bs={BATCH}): kernel {sc_kernel_ms:.3f} ms, plain "
        f"{sc_plain_ms:.3f} ms; bound {sc_bound:.4f} ms ({sc_bound_by}: "
        f"{n_bytes} B, {n_ops} f32 ops); library: none [{card}]")

    # ---- phase 4: the main path ----
    steps = 10
    cuda_scl.scl_subtree.launches = 0
    torch.cuda.synchronize()
    bits, bits_hat = model.step(gen, BATCH, EBNO_MAIN_DB)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = blk = 0
    for _ in range(steps):
        bits, bits_hat = model.step(gen, BATCH, EBNO_MAIN_DB)
        errs += count_errors(bits, bits_hat).item()
        blk += count_block_errors(bits, bits_hat).item()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = cuda_scl.scl_subtree.launches
    if launches == 0:
        raise AssertionError("the main path launched no scl_subtree kernel")
    if bits_hat.shape != (BATCH, K) or not torch.isin(
            bits_hat, torch.tensor([0.0, 1.0], device=dev)).all():
        raise AssertionError(f"decoder output of shape {bits_hat.shape} is "
                             "not a [batch, k] array of bits")
    info_bps = BATCH * K / step_s
    log(f"phase 4: k={K} n={N} SCL-{LIST_SIZE} {MODE} fast+rate-1, "
        f"bs={BATCH}, {EBNO_MAIN_DB} dB, b={main_b}: {step_s * 1e3:.1f} ms "
        f"per step, {info_bps:.4g} info bit/s; {launches} scl_subtree "
        f"launches in {steps + 1} steps; BER {errs / (steps * BATCH * K):.3g},"
        f" BLER {blk / (steps * BATCH):.4g} [{card}]")

    # ---- phase 5: BLER against the committed yardstick ----
    with open(os.path.join(ROOT, "benchmarks", "bler_validation.json")) as fh:
        yardsticks = json.load(fh)

    def yardstick(key, ebno_db):
        row = yardsticks[key]
        return row["bler"][row["ebno_db"].index(ebno_db)]

    want_bler = yardstick("scl8_n1024_fast_r1", EBNO_BLER_DB)
    blk = 0
    for _ in range(BLER_BLOCKS // BATCH):
        bits, bits_hat = model.step(gen, BATCH, EBNO_BLER_DB)
        blk += count_block_errors(bits, bits_hat).item()
    bler = blk / BLER_BLOCKS
    log(f"phase 5: BLER {bler:.5f} at {EBNO_BLER_DB} dB over {BLER_BLOCKS} "
        f"blocks; yardstick {want_bler:.5f} +- {BLER_TOL}")
    if abs(bler - want_bler) > BLER_TOL:
        raise AssertionError(f"BLER {bler} is off the yardstick {want_bler}")

    # ---- phase 6: the CLI path ----
    cfg = PolarConfig(k=K, n=N, construction="5g", bs=BATCH, algos=["scl"],
                      mc_iter=CLI_MC_ITER, target_block_errs=None, seed=SEED,
                      device=str(dev))
    log(f"phase 6: CLI sweep {cfg}")
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "sweep.jsonl")
        cuda_sc.sc_subtree.launches = 0
        cuda_scl.scl_subtree.launches = 0
        torch.cuda.synchronize()
        curves = sweep(cfg, ebno_dbs=CLI_EBNO_DB, jsonl_path=jsonl)
        torch.cuda.synchronize()
        cli_launches = {"sc_subtree": cuda_sc.sc_subtree.launches,
                        "scl_subtree": cuda_scl.scl_subtree.launches}
        with open(jsonl) as fh:
            rows = [json.loads(line) for line in fh]
    log(f"phase 6: launches during the sweep: {cli_launches}")
    if min(cli_launches.values()) == 0:
        raise AssertionError(f"the CLI sweep did not launch every kernel: "
                             f"{cli_launches}")
    names = [gate[0] for gate in CLI_GATES]
    if len(rows) != len(names) * len(CLI_EBNO_DB) or not all(
            np.isfinite(c).all() and ((0 <= c) & (c <= 1)).all()
            for c in curves.ber):
        raise AssertionError(f"the sweep gave {len(rows)} points and curves "
                             f"{curves.ber}")
    point = {}
    for i, row in enumerate(rows):
        name = names[i // len(CLI_EBNO_DB)]
        point[name, row["ebno_db"]] = row
        log(f"  {name} at {row['ebno_db']} dB: BLER "
            f"{row['block_errors'] / row['num_blocks']:.5f} over "
            f"{row['num_blocks']} blocks, {row['runtime_s']:.3f} s, "
            f"{K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s "
            f"[{card}]")
    for name, key, ebno_db, tol in CLI_GATES:
        row = point[name, ebno_db]
        got_bler = row["block_errors"] / row["num_blocks"]
        want = yardstick(key, ebno_db)
        log(f"phase 6: {name} BLER {got_bler:.5f} at {ebno_db} dB; "
            f"yardstick {key} {want:.5f} +- {tol}")
        if abs(got_bler - want) > tol:
            raise AssertionError(f"{name} BLER {got_bler} is off the "
                                 f"yardstick {want}")

    # ---- phase 7: where the time goes ----
    llr = model.front(gen, BATCH, EBNO_MAIN_DB)[2]
    for b in SC_SURVEY_DEPTHS:
        dec_b = PolarSCDecoder(frozen, N, mode=MODE, lower_stages=b,
                               device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=5)
        log(f"SC depth survey: decoder at b={b} ({N >> b} x {1 << b} "
            f"leaves): {ms:.3f} ms per batch of {BATCH} [{card}]")
    for b in PLAIN_SURVEY_DEPTHS:
        dec_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                                use_fast_scl=False, lower_stages=b,
                                device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=2)
        log(f"plain SCL depth survey: decoder at b={b} ({N >> b} x "
            f"{1 << b} leaves): {ms:.3f} ms per batch of {BATCH} [{card}]")
    for b in SURVEY_DEPTHS:
        dec_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                                use_fast_scl=True, fast_rate1=True,
                                lower_stages=b, device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=3)
        log(f"depth survey: decoder at b={b} ({N >> b} x {1 << b} leaves): "
            f"{ms:.3f} ms per batch of {BATCH} [{card}]")
    profile_step(model, gen)

    kernels = [{
        "name": "scl_subtree",
        "route": "cuda",
        "source": "polar_torch/csrc/scl_subtree.cu",
        "replaces": "polar_tpu/models/polar/pallas_scl.py:142",
        "launches": launches,
        "max_abs_err": check.max_abs,
        "mismatch_blocks": check.bad,
        "checked_blocks": check.blocks,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": scl_bound,
        "bound_by": scl_bound_by,
        "library_ms": None,
    }, {
        "name": "sc_subtree",
        "route": "cuda",
        "source": "polar_torch/csrc/sc_subtree.cu",
        "replaces": "polar_tpu/models/polar/pallas_scl.py:832",
        "launches": cli_launches["sc_subtree"],
        "max_abs_err": sc_check.max_abs,
        "mismatch_blocks": sum(sc_check.bad.values()),
        "checked_blocks": sum(sc_check.blocks.values()),
        "ms": sc_kernel_ms,
        "plain_ms": sc_plain_ms,
        "bound_ms": sc_bound,
        "bound_by": sc_bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}; main path {info_bps:.6g} info bit/s, "
          f"{step_s * 1e3:.3f} ms per step")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
