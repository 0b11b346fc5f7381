"""polar_torch on the card: the SCL and SC subtree kernels and the BP
kernel against their plain versions on the same CUDA inputs (the SCL
kernel at L up to 32 and in its traced form; BP with its lattice in shared
and in global memory, f32 and bf16 messages, and its per-codeword sweeps
and tracing's device counters), and the decoders (fast and plain SCL, SC,
the 5G CA-SCL and hybrid chain, BP single- and two-pass) on the card
against the same decoders on the CPU; OSD and the dense-G decoder, the
BEC channel, and the SC and SCL decoders on BEC logits, on the card
against the CPU;
the headline benchmark (``python -m polar_torch.bench``) at a small size;
the probe kernels (``polar_torch.probes``) against their plain versions;
the SCL sweep's closing transform (``butterfly_rows``) against its plain
version, and once a decode on the three main SCL chains; the QPSK
transmitter (``qpsk_front``) against its plain version and the composed
front end, and not on the 5G chain.
Every test here needs a CUDA card and skips without one.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_scl import (
    SubtreeSchedule, scl_subtree, scl_subtree_plain, traced_schedule)
from polar_torch.models.polar.scan_core import (leaf_schedule,
                                                split_fast_schedule)
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.utils import tracing

from _torch_parity import (BLOCK_AGREEMENT, assert_blocks_agree,
                           assert_osd_agrees, gather_zero_nan_input,
                           reduce_zero_nan_input)

LLR_MAX = 30.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _mask_5g(k, n):
    mask = np.zeros(n, bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


def _random_mask(n, seed):
    rng = np.random.default_rng(seed)
    return rng.random(n) < rng.uniform(0.2, 0.8)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["5g_n64_b3", "random_b4_spc",
                                  "5g_n1024_b6", "5g_n1024_b10"])
@pytest.mark.parametrize("L", [2, 8, 16, 32])
def test_kernel_equals_plain_on_card(cuda, case, L):
    mask, b, spc = {
        "5g_n64_b3": (_mask_5g(32, 64), 3, None),
        "random_b4_spc": (_random_mask(128, 1), 4, 2),
        "5g_n1024_b6": (_mask_5g(512, 1024), 6, None),
        "5g_n1024_b10": (_mask_5g(512, 1024), 10, None),
    }[case]
    units, _ = split_fast_schedule(mask, b, rate1=True, spc_min_stage=spc)
    rng = np.random.default_rng(b + L)
    for u in (u for u in units if u[0] == "sub"):
        ops = u[2]
        a = torch.from_numpy(rng.normal(0, 3, (1 << b, L, 1024)).astype(
            np.float32)).to(cuda)
        pm = torch.from_numpy(rng.exponential(2.0, (L, 1024)).astype(
            np.float32)).to(cuda)
        before = tracing.counter("launch.scl_subtree")
        got = scl_subtree(a, pm, SubtreeSchedule(ops, cuda), b=b,
                          llr_max=LLR_MAX, mode="minsum")
        torch.cuda.synchronize()
        assert tracing.counter("launch.scl_subtree") == before + 1
        assert all(x.device == a.device for x in got)
        want = scl_subtree_plain(a, pm, ops, b=b, llr_max=LLR_MAX,
                                 mode="minsum")
        assert_blocks_agree(
            tuple(x.cpu().numpy() for x in want[:2]),
            tuple(x.cpu().numpy() for x in got[:2]),
            want[2].cpu().numpy(), got[2].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("L,b", [(8, 10), (32, 8)])
def test_kernel_split_stages_equals_plain_on_card(cuda, L, b, mode):
    """Depths whose workspace outgrows the block's shared-memory budget:
    the upper stages go to the global scratch (the default split, and all
    stages global), against the plain version."""
    from polar_torch.models.polar.cuda_scl import shared_stages
    mask = _mask_5g(512, 1024)
    units, _ = split_fast_schedule(mask, b, rate1=True)
    rng = np.random.default_rng(b + L)
    n_default = shared_stages(b, L)
    assert n_default < b
    for ops in [u[2] for u in units if u[0] == "sub"][:2]:
        a = torch.from_numpy(rng.normal(0, 3, (1 << b, L, 512)).astype(
            np.float32)).to(cuda)
        pm = torch.from_numpy(rng.exponential(2.0, (L, 512)).astype(
            np.float32)).to(cuda)
        kw = dict(b=b, llr_max=LLR_MAX, mode=mode)
        sched = SubtreeSchedule(ops, cuda)
        got = scl_subtree(a, pm, sched, **kw)
        all_global = scl_subtree(a, pm, sched, n_shared=0, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, all_global))
        want = scl_subtree_plain(a, pm, ops, **kw)
        assert_blocks_agree(
            tuple(x.cpu().numpy() for x in want[:2]),
            tuple(x.cpu().numpy() for x in got[:2]),
            want[2].cpu().numpy(), got[2].cpu().numpy())


@pytest.mark.gpu
def test_wrapper_rejects_bad_cuda_inputs(cuda):
    sched = SubtreeSchedule((("i", 0, 0), ("i", 0, 1)), cuda)
    pm = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError):
        scl_subtree(torch.zeros(2, 8, 4, dtype=torch.float64, device=cuda),
                    pm, sched, b=1, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # schedule table on the CPU
        scl_subtree(torch.zeros(2, 8, 4, device=cuda), pm,
                    SubtreeSchedule((("i", 0, 0), ("i", 0, 1)), "cpu"),
                    b=1, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # 't' ops and no frz
        scl_subtree(torch.zeros(4, 8, 4, device=cuda), pm,
                    SubtreeSchedule(traced_schedule(2), cuda), b=2,
                    llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # more shared stages than b
        scl_subtree(torch.zeros(2, 8, 4, device=cuda), pm, sched, b=1,
                    llr_max=LLR_MAX, mode="minsum", n_shared=2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("L", [8, 16, 32])
def test_traced_kernel_equals_static_on_card(cuda, L, mode):
    """The traced form (one schedule, frozen flags as data) is bit-equal
    to the static leaf schedule on the card, and agrees with the plain
    version."""
    b = 6
    mask = _mask_5g(512, 1024)
    rng = np.random.default_rng(L)
    for j in (0, 7, 15):
        sub = mask.reshape(16, 64)[j]
        a = torch.from_numpy(rng.normal(0, 3, (64, L, 512)).astype(
            np.float32)).to(cuda)
        pm = torch.from_numpy(rng.exponential(2.0, (L, 512)).astype(
            np.float32)).to(cuda)
        frz = torch.from_numpy(sub.astype(np.int32)).to(cuda)
        kw = dict(b=b, llr_max=LLR_MAX, mode=mode)
        before = tracing.counter("form.scl_subtree.traced")
        got = scl_subtree(a, pm, SubtreeSchedule(traced_schedule(b), cuda),
                          frz=frz, **kw)
        assert tracing.counter("form.scl_subtree.traced") == before + 1
        static = scl_subtree(a, pm, SubtreeSchedule(leaf_schedule(sub), cuda),
                             **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, static))
        want = scl_subtree_plain(a, pm, traced_schedule(b), frz=frz, **kw)
        assert_blocks_agree(
            tuple(x.cpu().numpy() for x in want[:2]),
            tuple(x.cpu().numpy() for x in got[:2]),
            want[2].cpu().numpy(), got[2].cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 8])
def test_decoder_on_card_equals_cpu(cuda, b):
    n, k, bs = 256, 128, 2048
    frozen, _ = generate_5g_ranking(k, n)
    rng = np.random.default_rng(b)
    c = rng.integers(0, 2, (bs, n))
    logits = torch.from_numpy(
        (-(2.0 / 0.64) * ((1.0 - 2.0 * c) + rng.normal(0, 0.8, (bs, n))))
        .astype(np.float32))
    kw = dict(list_size=8, use_fast_scl=True, fast_rate1=True,
              lower_stages=b)
    want = PolarSCLDecoder(frozen, n, device="cpu", **kw)(logits)
    before = tracing.counter("launch.scl_subtree")
    got = PolarSCLDecoder(frozen, n, device=cuda, **kw)(logits.to(cuda))
    assert tracing.counter("launch.scl_subtree") > before
    agree = (got.cpu() == want).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("b,lanes,n_shared", [
    (3, None, None), (6, None, None), (10, None, None),
    # one leaf; segments narrower than 32 lanes; the workspace split
    # between shared memory and the global scratch, or all global
    (1, None, None), (8, 32, None), (9, None, None), (9, 16, 4),
    (10, 4, 0)])
def test_sc_kernel_equals_plain_on_card(cuda, b, lanes, n_shared, mode):
    """On 2051 columns, which no block's codeword count divides."""
    from polar_torch.models.polar.cuda_sc import (
        sc_schedule, sc_subtree, sc_subtree_plain, traced_schedule)
    from polar_torch.models.polar.scan_core import fast_schedule
    rng = np.random.default_rng(b)
    mask = _mask_5g(1 << (b - 1), 1 << b) if b >= 5 else _random_mask(
        1 << b, b)
    a = torch.from_numpy(rng.normal(0, 3, (1 << b, 2051)).astype(
        np.float32)).to(cuda)
    frz = torch.from_numpy(mask.astype(np.int32)).to(cuda)
    for ops in (fast_schedule(mask, rep=False), traced_schedule(b)):
        before = tracing.counter("launch.sc_subtree")
        got = sc_subtree(a, frz, sc_schedule(ops, cuda), b=b,
                         llr_max=LLR_MAX, mode=mode, lanes=lanes,
                         n_shared=n_shared)
        torch.cuda.synchronize()
        assert tracing.counter("launch.sc_subtree") == before + 1
        assert got.device == a.device and got.dtype == torch.int32
        want = sc_subtree_plain(a, frz, ops, b=b, llr_max=LLR_MAX,
                                mode=mode)
        agree = (got == want).all(dim=0).float().mean().item()
        # min-sum is exact; the exact boxplus rounds differently in
        # log1pf/expf and torch.logaddexp
        assert agree == 1.0 if mode == "minsum" else agree >= 0.999


@pytest.mark.gpu
def test_sc_wrapper_rejects_bad_cuda_inputs(cuda):
    from polar_torch.models.polar.cuda_sc import (sc_schedule, sc_subtree,
                                                  traced_schedule)
    sched = sc_schedule(traced_schedule(2), cuda)
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError):       # 't' ops and no frz
        sc_subtree(a, None, sched, b=2, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(TypeError):
        sc_subtree(a.double(), torch.zeros(4, dtype=torch.int32,
                                           device=cuda), sched, b=2,
                   llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # schedule table on the CPU
        sc_subtree(a, torch.zeros(4, dtype=torch.int32, device=cuda),
                   sc_schedule(traced_schedule(2), "cpu"), b=2,
                   llr_max=LLR_MAX, mode="minsum")


def _logits(n, bs, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (bs, n))
    return torch.from_numpy(
        (-(2.0 / 0.64) * ((1.0 - 2.0 * c) + rng.normal(0, 0.8, (bs, n))))
        .astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 10])
def test_sc_decoder_on_card_equals_cpu(cuda, b):
    from polar_torch.models.polar.sc import PolarSCDecoder
    n, k = 1024, 512
    frozen, _ = generate_5g_ranking(k, n)
    logits = _logits(n, 2048, b)
    want = PolarSCDecoder(frozen, n, lower_stages=b, device="cpu")(logits)
    before = tracing.counter("launch.sc_subtree")
    got = PolarSCDecoder(frozen, n, lower_stages=b, device=cuda)(
        logits.to(cuda))
    assert tracing.counter("launch.sc_subtree") > before
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_plain_scl_decoder_on_card_equals_cpu(cuda):
    n, k, bs = 256, 128, 2048
    frozen, _ = generate_5g_ranking(k, n)
    logits = _logits(n, bs, 5)
    dec_cpu = PolarSCLDecoder(frozen, n, list_size=8, device="cpu")
    assert not dec_cpu.use_fast_scl
    want = dec_cpu(logits)
    before = tracing.counter("launch.scl_subtree")
    got = PolarSCLDecoder(frozen, n, list_size=8, device=cuda)(
        logits.to(cuda))
    assert tracing.counter("launch.scl_subtree") > before
    agree = (got.cpu() == want).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT


@pytest.mark.gpu
@pytest.mark.parametrize("dec_type,L", [("SCL", 8), ("SCL", 32),
                                        ("hybSCL", 8), ("SC", 8)])
def test_5g_decoder_on_card_equals_cpu(cuda, dec_type, L):
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    rng = np.random.default_rng(L)
    enc_cpu = Polar5GEncoder(400, 1000, device="cpu")
    u = rng.integers(0, 2, (512, 400)).astype(np.float32)
    c = enc_cpu(torch.from_numpy(u)).numpy()
    logits = torch.from_numpy(((2.0 / 0.72) * ((2.0 * c - 1.0) + rng.normal(
        0, 0.85, c.shape))).astype(np.float32))
    kw = dict(dec_type=dec_type, list_size=L, mode="exact",
              return_crc_status=True)
    want, ok_want = Polar5GDecoder(enc_cpu, **kw)(logits)
    got, ok_got = Polar5GDecoder(Polar5GEncoder(400, 1000, device=cuda),
                                 **kw)(logits.to(cuda))
    agree = (got.cpu() == want).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT
    assert (ok_got.cpu() == ok_want).float().mean().item() >= BLOCK_AGREEMENT


def _bp_inputs(n, bs, ebno_db, seed):
    """(prior [n], logits [bs, n]) of random codewords of a rate-1/2 code
    (5G table up to n=1024, the RM-style construction beyond)."""
    from polar_torch.models.polar.construction import get_kern_frozen_bits
    from polar_torch.models.polar.encode import PolarEncoder
    frozen = (generate_5g_ranking(n // 2, n)[0] if n <= 1024
              else get_kern_frozen_bits(n, n // 2)[2])
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (bs, n // 2)).astype(np.float32)
    c = PolarEncoder(frozen, n, device="cpu")(torch.from_numpy(u)).numpy()
    sigma = np.sqrt(1.0 / 10 ** (ebno_db / 10))
    logits = (2.0 / sigma ** 2) * ((2.0 * c - 1.0)
                                   + rng.normal(0, sigma, c.shape))
    prior = np.zeros(n, np.float32)
    prior[frozen] = LLR_MAX
    return torch.from_numpy(prior), torch.from_numpy(logits.astype(
        np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,lattice,msf,early_stop,num_iter,check_every,extra", [
        (64, "auto", 1.0, True, 21, 1, {}),
        (256, "auto", 0.9375, True, 21, 2, {}),
        (1024, "shared", 0.9375, True, 20, 2, {}),
        (1024, "global", 0.9375, True, 20, 2, {}),
        (1024, "auto", 0.9375, False, 20, 1, {}),
        (2048, "auto", 0.9375, True, 13, 2, {}),
        (4096, "auto", 0.9375, True, 9, 2, {}),
        # the tiled form's groups: S = 7 and 10 end on a group of one
        # stage, S = 9 on a whole group, S = 11 on a group of two;
        # check_every 1 and 3 with odd sweep counts
        (128, "auto", 0.9375, True, 11, 3, {}),
        (512, "auto", 1.0, True, 13, 1, {}),
        (1024, "auto", 0.9375, True, 21, 3, {}),
        (2048, "auto", 0.9375, True, 15, 3, {}),
        # the benchmark cell's shape; the bf16 lattice; exact mode
        (1024, "auto", 0.9375, True, 20, 2, dict(bs=65536)),
        (1024, "auto", 0.9375, True, 20, 2, dict(msg_dtype="bf16")),
        (2048, "auto", 0.9375, True, 13, 3, dict(msg_dtype="bf16")),
        (256, "auto", 0.9375, True, 20, 2, dict(mode="exact")),
    ])
def test_bp_kernel_equals_plain_on_card(cuda, n, lattice, msf, early_stop,
                                        num_iter, check_every, extra):
    """Every LLR, flag and per-codeword sweep count bit-equal to the plain
    version on the same CUDA inputs (the kernel reads the logits through a
    transposed view and negates them on load)."""
    import ctypes
    from polar_torch import _build
    from polar_torch.models.polar.cuda_bp import (_native_call, bp_decode,
                                                  bp_decode_plain)
    bs = extra.get("bs", 256 if n >= 2048 else 2048)
    prior, logits = _bp_inputs(n, bs, 2.0, n)
    prior, logits = prior.to(cuda), logits.to(cuda)
    kw = dict(num_iter=num_iter, check_every=check_every,
              early_stop=early_stop, mode=extra.get("mode", "minsum"),
              msf=msf, llr_max=LLR_MAX, return_done=early_stop,
              msg_dtype=(torch.bfloat16 if extra.get("msg_dtype") == "bf16"
                         else torch.float32))
    before = tracing.counter("launch.bp")
    got = bp_decode(logits.t(), prior, negate=True, lattice=lattice, **kw)
    torch.cuda.synchronize()
    assert tracing.counter("launch.bp") == before + 1
    sw = torch.full((bs,), -1, dtype=torch.int32, device=cuda)
    stream = (ctypes.c_void_p, torch.cuda.current_stream(cuda).cuda_stream)
    got_sw = _native_call(_build.load("bp", "cuda").bp_launch, logits.t(),
                          prior, lattice, stream, negate=True, sweeps=sw,
                          **kw)
    want_sw = torch.empty(bs, dtype=torch.int32, device=cuda)
    want = bp_decode_plain(-logits.t(), prior, sweeps=want_sw, **kw)
    assert torch.equal(sw, want_sw)
    if early_stop:
        assert torch.equal(got[1], want[1]) and torch.equal(got_sw[1],
                                                            want[1])
        got, got_sw, want = got[0], got_sw[0], want[0]
    assert got.device == logits.device and torch.equal(got, want)
    assert torch.equal(got_sw, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,lattice,msg_dtype,ebno_db", [
    (1024, "shared", torch.float32, 2.0),
    (1024, "global", torch.float32, 2.0),
    (2048, "auto", torch.float32, 5.0),
    (1024, "auto", torch.bfloat16, 2.0)])
def test_bp_kernel_sweeps_on_card(cuda, n, lattice, msg_dtype, ebno_db):
    """The kernel's per-codeword sweeps output equals the plain version's,
    the other outputs are bit-equal with it and without it, and a traced
    ``bp_decode`` reports their sums as the device counters ``sweeps.bp``
    and ``converged.bp``. Each point has codewords that converge and
    codewords that do not (n = 2048 takes the construction beyond the 5G
    table, on which BP needs more signal)."""
    import ctypes
    from polar_torch import _build
    from polar_torch.models.polar import cuda_bp
    from polar_torch.models.polar.cuda_bp import (_native_call, bp_decode,
                                                  bp_decode_plain)
    bs = 512 if n >= 2048 else 2048
    prior, logits = _bp_inputs(n, bs, ebno_db, n + 7)
    prior, llr = prior.to(cuda), (-logits).t().contiguous().to(cuda)
    kw = dict(num_iter=20, check_every=2, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX, msg_dtype=msg_dtype)
    want_sw = torch.empty(bs, dtype=torch.int32, device=cuda)
    want, done = bp_decode_plain(llr, prior, return_done=True,
                                 sweeps=want_sw, **kw)
    sw = torch.full((bs,), -1, dtype=torch.int32, device=cuda)
    stream = (ctypes.c_void_p, torch.cuda.current_stream(cuda).cuda_stream)
    got, got_done = _native_call(_build.load("bp", "cuda").bp_launch, llr,
                                 prior, lattice, stream, return_done=True,
                                 sweeps=sw, **kw)
    off = bp_decode(llr, prior, lattice=lattice, **kw)
    with tracing.enabled():
        with tracing.batch():
            on = bp_decode(llr, prior, lattice=lattice, **kw)
    s = tracing.summary()
    c = s["device_counters"]
    # the launch's form and its plan's barriers a sweep, counted traced
    span = s["spans"]["kernel.bp"]
    shared = cuda_bp.resolve_lattice(n, lattice) == "shared"
    assert span.get("form.bp.tiled", 0) == int(shared)
    assert span["syncs.bp"] == cuda_bp.launch_plan(n, lattice, msg_dtype)[1]
    assert torch.equal(sw, want_sw) and torch.equal(got_done, done)
    assert 0 < done.sum() < bs
    for x in (got, off, on):
        assert torch.equal(x, want)
    assert c == {"sweeps.bp": {"sum": int(want_sw.sum()), "items": bs},
                 "converged.bp": {"sum": int(done.sum()), "items": bs}}


@pytest.mark.gpu
def test_bp_kernel_exact_mode_on_card(cuda):
    """Exact mode rounds differently in expf/log1pf and torch.logaddexp:
    decisions equal on every block the plain version marks converged, and
    on 99% of all blocks."""
    from polar_torch.models.polar.cuda_bp import bp_decode, bp_decode_plain
    prior, logits = _bp_inputs(1024, 2048, 2.0, 3)
    prior, llr = prior.to(cuda), (-logits).t().contiguous().to(cuda)
    kw = dict(num_iter=20, check_every=2, early_stop=True, mode="exact",
              msf=0.9375, llr_max=LLR_MAX, return_done=True)
    got, _ = bp_decode(llr, prior, **kw)
    want, done = bp_decode_plain(llr, prior, **kw)
    info = prior == 0
    differ = ((got <= 0) != (want <= 0))[info].any(dim=0)
    assert not differ[done > 0].any()
    assert differ.float().mean().item() <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("n,lattice,mode", [
    (1024, "auto", "minsum"), (1024, "global", "minsum"),
    (2048, "auto", "minsum"), (4096, "auto", "minsum"),
    (256, "auto", "minsum"), (1024, "auto", "exact")])
def test_bp_bf16_kernel_equals_plain_on_card(cuda, n, lattice, mode):
    """The bf16 instance against ``bp_decode_plain(msg_dtype=bf16)`` on the
    same CUDA inputs: min-sum bit-equal (every LLR and flag); exact mode
    by decisions, equal on every block the plain version marks converged
    and on 99% of all."""
    from polar_torch.models.polar.cuda_bp import bp_decode, bp_decode_plain
    bs = 256 if n >= 2048 else 2048
    prior, logits = _bp_inputs(n, bs, 2.0, n + 1)
    prior, logits = prior.to(cuda), logits.to(cuda)
    kw = dict(num_iter=13, check_every=2, early_stop=True, mode=mode,
              msf=0.9375, llr_max=LLR_MAX, return_done=True,
              msg_dtype=torch.bfloat16)
    before = tracing.counter("form.bp.bf16")
    got, got_done = bp_decode(logits.t(), prior, negate=True,
                              lattice=lattice, **kw)
    torch.cuda.synchronize()
    assert tracing.counter("form.bp.bf16") == before + 1
    want, done = bp_decode_plain(-logits.t(), prior, **kw)
    if mode == "minsum":
        assert torch.equal(got_done, done) and torch.equal(got, want)
        return
    differ = ((got <= 0) != (want <= 0))[prior == 0].any(dim=0)
    assert not differ[done > 0].any()
    assert differ.float().mean().item() <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("two_pass", [False, True])
def test_bp_decoder_on_card_equals_cpu(cuda, two_pass):
    from polar_torch.models.polar.bp import PolarBPDecoder
    n, k = 1024, 512
    frozen, _ = generate_5g_ranking(k, n)
    _, logits = _bp_inputs(n, 1024, 2.0, 7)
    for msg in (torch.float32, torch.bfloat16):
        kw = dict(num_iter=20, hard_out=False, two_pass=two_pass,
                  msg_dtype=msg)
        want = PolarBPDecoder(frozen, n, device="cpu", **kw)(logits)
        before = tracing.counter("launch.bp")
        got = PolarBPDecoder(frozen, n, device=cuda, **kw)(logits.to(cuda))
        assert tracing.counter("launch.bp") > before
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_bp_wrapper_rejects_bad_cuda_inputs(cuda):
    from polar_torch.models.polar.cuda_bp import bp_decode
    kw = dict(num_iter=2, check_every=1, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX)
    prior = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        bp_decode(torch.zeros(8, 4, dtype=torch.float64, device=cuda), prior,
                  **kw)
    with pytest.raises(ValueError):       # the prior on the CPU
        bp_decode(torch.zeros(8, 4, device=cuda), torch.zeros(8), **kw)
    with pytest.raises(ValueError):       # no room in shared memory
        bp_decode(torch.zeros(4096, 4, device=cuda),
                  torch.zeros(4096, device=cuda), lattice="shared", **kw)


@pytest.mark.gpu
def test_osd_on_card_equals_cpu(cuda):
    """OSD-2 on the 5G (64, 128) code in chunks of 1024 patterns: valid
    codewords, and the CPU's under the tie rule."""
    from polar_torch.models.osd import OSDecoder
    from polar_torch.models.polar.encode import PolarEncoder
    frozen, _ = generate_5g_ranking(64, 128)
    llr = np.random.default_rng(0).normal(0, 2, (512, 128)).astype(
        np.float32)
    enc = PolarEncoder(frozen, 128, device=cuda)
    dec = OSDecoder(t=2, encoder=enc, pattern_chunk=1024)
    assert dec.device == cuda
    got = dec(torch.from_numpy(llr).to(cuda))
    assert bool(enc.parity_check(got).all())
    want = OSDecoder(t=2, encoder=PolarEncoder(frozen, 128, device="cpu"),
                     pattern_chunk=1024)(torch.from_numpy(llr))
    assert_osd_agrees(llr, got.cpu().numpy(), want.numpy(), llr_max=100.0)


@pytest.mark.gpu
def test_dense_decoder_on_card_equals_cpu(cuda):
    from polar_torch.models.polar.construction import get_ref_rm_frozen_bits
    from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                                DenseKernelEncoder)
    from polar_torch.models.polar.kernels import get_kernel
    n, k = 256, 128
    kern = get_kernel("G16")
    frozen = get_ref_rm_frozen_bits(n, n - k, "G16")
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (128, k)).astype(np.float32)
    enc_cpu = DenseKernelEncoder(frozen, n, kern, device="cpu")
    c = enc_cpu(torch.from_numpy(u))
    enc = DenseKernelEncoder(frozen, n, kern, device=cuda)
    assert torch.equal(enc(torch.from_numpy(u).to(cuda)).cpu(), c)
    llr = ((2.0 * c - 1.0) * 2.0 + torch.from_numpy(rng.normal(
        0, 1.2, c.shape).astype(np.float32))).numpy()
    dec, dec_cpu = DenseKernelDecoder(enc, t=1), DenseKernelDecoder(enc_cpu,
                                                                   t=1)
    c_got = dec._osd(torch.from_numpy(llr).to(cuda)).cpu().numpy()
    c_want = dec_cpu._osd(torch.from_numpy(llr)).numpy()
    assert_osd_agrees(llr, c_got, c_want, llr_max=100.0)
    same = torch.from_numpy(~(c_got != c_want).any(axis=1))
    got = dec(torch.from_numpy(llr).to(cuda)).cpu()
    assert torch.equal(got[same], dec_cpu(torch.from_numpy(llr))[same])


@pytest.mark.gpu
def test_bec_channel_on_card(cuda):
    from polar_torch.ops.channels import BinaryErasureChannel
    x = torch.randint(0, 2, (200_000,), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0)).float()
    ch = BinaryErasureChannel(return_llrs=True)
    y = ch(torch.Generator(device=cuda).manual_seed(1), (x, 0.3))
    share = (y == 0).float().mean().item()
    assert abs(share - 0.3) <= 4.0 * (0.3 * 0.7 / x.numel()) ** 0.5
    live = y != 0
    assert torch.equal(y[live] > 0, x[live] == 1)
    erased = ch(torch.Generator(device=cuda).manual_seed(2), (x, 1.0))
    assert bool((erased == 0).all())
    assert torch.equal(torch.signbit(erased), x == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", [0.3, 0.45])
def test_decoders_on_bec_logits_card_equal_cpu(cuda, pe):
    """SC bit-equal, SCL-8 under the block rule, on BEC logits (+-100,
    erasures as signed zeros) of the 5G k=512 n=1024 code."""
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.models.polar.sc import PolarSCDecoder
    from polar_torch.ops.channels import BinaryErasureChannel
    n, k, bs = 1024, 512, 1024
    frozen, _ = generate_5g_ranking(k, n)
    gen = torch.Generator(device=cuda).manual_seed(int(pe * 100))
    u = torch.randint(0, 2, (bs, k), device=cuda, generator=gen).float()
    c = PolarEncoder(frozen, n, device=cuda)(u)
    logits = BinaryErasureChannel(return_llrs=True)(gen, (c, pe))
    before = tracing.counter("launch.sc_subtree")
    got = PolarSCDecoder(frozen, n, device=cuda)(logits)
    assert tracing.counter("launch.sc_subtree") > before
    assert torch.equal(got.cpu(), PolarSCDecoder(frozen, n, device="cpu")(
        logits.cpu()))
    before = tracing.counter("launch.scl_subtree")
    got = PolarSCLDecoder(frozen, n, list_size=8, device=cuda)(logits)
    assert tracing.counter("launch.scl_subtree") > before
    want = PolarSCLDecoder(frozen, n, list_size=8, device="cpu")(
        logits.cpu())
    agree = (got.cpu() == want).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("code", [(19, 864), (12, 48)])
def test_pc_kernels_equal_plain_on_card(cuda, code, mode):
    """The ``'p'`` leaves of both kernels (the whole tree in one call) on
    the mother codes of the uplink PC codes: SCL at L = 8, 16 and 32 under
    the block rule (min-sum: every block, path metrics bit for bit), with
    the aligned blocks of frozen leaves as frozen-run rows of the table
    (counted once a launch), SC on every block in min-sum."""
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_sc import sc_subtree_plain
    from polar_torch.models.polar.encode import Polar5GEncoder
    enc = Polar5GEncoder(*code, device="cpu")
    n = enc.n_polar
    S = n.bit_length() - 1
    mask = np.zeros(n, bool)
    mask[enc.frozen_pos] = True
    pc = np.zeros(n, bool)
    pc[enc.pc_pos] = True
    llr = 3.0 * torch.randn((n, 1024), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(n))
    rows, run_leaves = {(19, 864): (54, 220), (12, 48): (35, 36)}[code]
    for L in (8, 16, 32):
        plan = scan_core.plan_plain_sweep(mask, S, cuda, pc_mask=pc)
        kw = dict(mode=mode, llr_max=LLR_MAX, lower_stages=S, plan=plan)
        before = (tracing.counter("ops.scl_subtree"),
                  tracing.counter("leaves.scl_subtree.run"),
                  tracing.counter("launch.scl_subtree"))
        u_k, pm_k = scan_core.scl_sweep_hybrid(llr, mask, L, **kw)
        after = (tracing.counter("ops.scl_subtree"),
                 tracing.counter("leaves.scl_subtree.run"),
                 tracing.counter("launch.scl_subtree"))
        assert [y - x for x, y in zip(before, after)] == [rows, run_leaves,
                                                          1]
        u_p, pm_p = scan_core.scl_sweep_hybrid(
            llr, mask, L, subtree=lambda a, pm, s, **k: scl_subtree_plain(
                a, pm, s.ops, **k), **kw)
        if mode == "minsum":
            assert torch.equal(u_k, u_p) and torch.equal(pm_k, pm_p)
        else:
            assert_blocks_agree((u_p.cpu().numpy(),), (u_k.cpu().numpy(),),
                                pm_p.cpu().numpy(), pm_k.cpu().numpy())
    plan = scan_core.plan_sc_sweep(mask, S, cuda, pc_mask=pc)
    kw = dict(mode=mode, llr_max=LLR_MAX, lower_stages=S, plan=plan)
    u_k = scan_core.sc_sweep_hybrid(llr, mask, **kw)
    u_p = scan_core.sc_sweep_hybrid(
        llr, mask, subtree=lambda a, f, s, **k: sc_subtree_plain(
            a, f, s.ops, **k), **kw)
    agree = (u_k == u_p).all(0).float().mean().item()
    assert agree == 1.0 if mode == "minsum" else agree >= BLOCK_AGREEMENT


@pytest.mark.gpu
@pytest.mark.parametrize("dec_type", ["SC", "SCL", "hybSCL"])
def test_pc_5g_decoder_on_card_equals_cpu(cuda, dec_type):
    """The uplink (19, 864) code with 3 PC bits through ``Polar5GDecoder``
    on the card, against the CPU, with its kernels launched."""
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    rng = np.random.default_rng(19)
    enc_cpu = Polar5GEncoder(19, 864, device="cpu")
    u = rng.integers(0, 2, (512, 19)).astype(np.float32)
    c = enc_cpu(torch.from_numpy(u)).numpy()
    logits = torch.from_numpy((2.0 * ((2.0 * c - 1.0) + rng.normal(
        0, 4.0, c.shape)) / 16.0).astype(np.float32))
    kw = dict(dec_type=dec_type, list_size=8, mode="exact",
              return_crc_status=True)
    want, ok_want = Polar5GDecoder(enc_cpu, **kw)(logits)
    before = (tracing.counter("launch.scl_subtree"),
              tracing.counter("launch.sc_subtree"))
    got, ok_got = Polar5GDecoder(Polar5GEncoder(19, 864, device=cuda),
                                 **kw)(logits.to(cuda))
    after = (tracing.counter("launch.scl_subtree"),
             tracing.counter("launch.sc_subtree"))
    assert after[0] > before[0] or dec_type == "SC"
    assert after[1] > before[1] or dec_type == "SCL"
    assert 0 < int(ok_want.sum()) < 512
    agree = (got.cpu() == want).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT
    assert (ok_got.cpu() == ok_want).float().mean().item() >= BLOCK_AGREEMENT


@pytest.mark.gpu
def test_tools_on_card(cuda, tmp_path):
    """``ShardedSystem`` with a world of one on NCCL equals the unsharded
    model on the derived generator; ``trace`` names the SCL kernel;
    ``flop_estimate`` counts the kernel's work."""
    import json
    import os
    import socket
    import torch.distributed as dist
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.systems import SystemAWGNModel
    from polar_torch.parallel import ShardedSystem, initialize
    from polar_torch.sim import count_block_errors, count_errors, fold_in
    from polar_torch.utils.profiling import flop_estimate, trace
    enc = Polar5GEncoder(12, 48, device=cuda)
    model = SystemAWGNModel(48, 12, enc, Polar5GDecoder(enc, "SCL"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert initialize(f"tcp://localhost:{port}", world_size=1, rank=0,
                      timeout_s=60) == (0, 1, 1)
    try:
        gen = torch.Generator(cuda).manual_seed(3)
        got = ShardedSystem(model).counted_step(gen, 512, 2.0)
        b, b_hat = model.step(fold_in(gen, 0), 512, 2.0)
        assert got == (count_errors(b, b_hat).item(),
                       count_block_errors(b, b_hat).item(), 512 * 12, 512)
    finally:
        dist.destroy_process_group()
    with trace(str(tmp_path)):
        model.step(gen, 512, 2.0)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        assert "scl_subtree_kernel" in json.dumps(json.load(fh))
    assert flop_estimate(lambda: model.step(gen, 512, 2.0)) > 0


@pytest.mark.gpu
def test_bench_on_card(cuda):
    """``python -m polar_torch.bench`` at a small size on the card: one
    JSON line with the card's name, info bit/s and the SCL kernel's
    launches over the timed steps."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "polar_torch.bench", "--k", "128", "--n",
         "256", "--bs", "1024", "--iters", "3", "--warmup", "1"], cwd=repo,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (line,) = out.stdout.strip().splitlines()
    row = json.loads(line)
    assert row["metric"] == "scl8_n256_chain_info_bits_per_s"
    assert row["value"] > 0 and row["ms_per_step"] > 0
    assert row["scl_subtree_launches"] >= 3
    assert row["device"] != "cpu" and row["lower_stages"] == 8


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fori", "bcast", "roll", "reduce", "shift",
                                  "scratchfori", "sweepcombo", "bigsweep",
                                  "bigsweep_noloop", "arith", "gather",
                                  "int8"])
def test_probe_kernel_equals_plain_on_card(cuda, name):
    """Each probe kernel against its plain version on the card, bit for
    bit, at the script's inputs, another draw and (f32 probes) a wider
    input than the script's four blocks ([64, 768]); the stage sweeps also
    on signed zeros and NaNs (``reduce_zero_nan_input``, f32 of random
    bits at [64, 512] and [64, 768], every ordered pair of NaNs, +-1 and
    +-0 at each stage of ``k_sweepcombo``); ``reduce`` also on signed zeros
    and NaNs of two payloads each side of its row split, on [64, 1536]
    and on a tensor not 16-byte aligned; ``gather`` on random bf16 bits
    (NaNs, signed zeros) and on [16, 1024], [8, 250] (element by element
    past the last 8 columns), [3072, 16] (12 units a thread, the 48 KiB
    tile), [3073, 24] (straight from ``x``) and a tensor not 16-byte
    aligned; ``int8`` on every int8 value at [3, 17], [32, 250] (a partial
    16-byte unit, masked byte by byte) and [1000, 1000] (many CTAs), and
    a tensor not 16-byte aligned (byte by byte)."""
    from polar_torch import probes
    step = "bf16" if name in probes.BF16 else f"mini:{name}"
    cases = [probes.step_inputs(step, seed)[name] for seed in (0, 7)]
    if name in probes.MINI:
        cases.append((torch.from_numpy(np.random.default_rng(3).normal(
            0, 2, (64, 6 * 128)).astype(np.float32)),))
    if name in ("sweepcombo", "bigsweep", "bigsweep_noloop"):
        cases += [(reduce_zero_nan_input(probes.mini_input(4)),),
                  (probes.bits_input(0),), (probes.bits_input(9, 768),),
                  (probes.pair_input(0),)]
    if name == "reduce":
        cases += [(reduce_zero_nan_input(probes.mini_input(4)),),
                  (reduce_zero_nan_input(torch.from_numpy(
                      np.random.default_rng(5).normal(
                          0, 2, (64, 1536)).astype(np.float32))),),
                  "unaligned"]
    if name == "int8":
        for shape in ((3, 17), (32, 250), (1000, 1000)):
            x = torch.from_numpy(np.random.default_rng(shape[1]).integers(
                -128, 128, shape).astype(np.int8))
            x.view(-1)[:256] = torch.arange(-128, 128, dtype=torch.int8)[
                :x.numel()]
            cases.append((x,))
        cases += ["unaligned"]
    if name == "gather":
        cases += [gather_zero_nan_input(8, 256, 8),
                  gather_zero_nan_input(16, 1024, 16),
                  gather_zero_nan_input(8, 250, 10),
                  gather_zero_nan_input(3072, 16, 12),
                  gather_zero_nan_input(3073, 24, 13), "unaligned"]
    for args in cases:
        if args == "unaligned":
            args = (cases[-2] if name in ("reduce", "int8")
                    else gather_zero_nan_input(8, 256, 11))
            x = args[0].to(cuda)
            flat = x.new_empty(x.numel() + 1)
            flat[1:] = x.flatten()
            args = (flat[1:].view(x.shape),) + args[1:]  # one element past
            assert args[0].data_ptr() % 16 and args[0].is_contiguous()
        args = tuple(a.to(cuda) for a in args)
        before = tracing.counter(f"launch.probe.{name}")
        got = probes.WRAPPERS[name](*args)
        torch.cuda.synchronize()
        assert tracing.counter(f"launch.probe.{name}") == before + 1
        assert got.device == args[0].device
        assert probes.differing(probes.PLAIN[name](*args), got) == 0
        # the host build agrees too
        cpu = tuple(a.cpu() for a in args)
        assert probes.differing(probes.probe_host(name, *cpu),
                                got.cpu()) == 0


@pytest.mark.gpu
def test_probe_wrappers_raise_on_the_card(cuda):
    """``gather`` raises on a CPU/CUDA mix of ``x`` and its pointers, and
    launches nothing."""
    from polar_torch import probes
    x, ptr = probes.bf16_inputs()["gather"]
    before = probes.launch_counts()
    with pytest.raises(ValueError, match="pointers"):
        probes.gather(x.to(cuda), ptr)
    with pytest.raises(ValueError, match="pointers"):
        probes.gather(x, ptr.to(cuda))
    assert probes.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((1, 1024, 8 * 8192), torch.int32),     # the fast SCL-8 main path
    ((1, 256, 8 * 65536), torch.int32),     # the uplink UCI chain, bs 65536
    ((4, 256, 8 * 2048), torch.int8)])      # the plain sweep at b < S
def test_butterfly_kernel_equals_plain_on_card(cuda, shape, dtype):
    """``butterfly_rows`` at the main paths' shapes, bit for bit."""
    from polar_torch.models.polar.cuda_butterfly import (
        butterfly_rows, butterfly_rows_plain)
    gen = torch.Generator(cuda).manual_seed(shape[1])
    x = torch.randint(0, 2, shape, generator=gen, dtype=dtype, device=cuda)
    before = tracing.counter("launch.butterfly_rows")
    got = butterfly_rows(x)
    torch.cuda.synchronize()
    assert tracing.counter("launch.butterfly_rows") == before + 1
    assert got.device == x.device and got.dtype == torch.int8
    assert torch.equal(got, butterfly_rows_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("b", range(1, 13))
def test_butterfly_kernel_every_width_on_card(cuda, b):
    """w = 2^b, int32 (any bits above bit 0) and int8, on column counts
    that fill no block, and on strided blocks and rows."""
    from polar_torch.models.polar.cuda_butterfly import (
        butterfly_rows, butterfly_rows_plain)
    gen = torch.Generator(cuda).manual_seed(b)
    for C in (1, 33, 4100):
        for dtype in (torch.int32, torch.int8):
            x = torch.randint(-100, 100, (3, 1 << b, C), generator=gen,
                              dtype=dtype, device=cuda)
            assert torch.equal(butterfly_rows(x), butterfly_rows_plain(x))
    x = torch.randint(0, 2, (1 << b, 3, 40), generator=gen,
                      dtype=torch.int32, device=cuda).transpose(0, 1)
    assert torch.equal(butterfly_rows(x), butterfly_rows_plain(x))


def _butterfly_chain(chain, device):
    """A decoder of one of the three main chains on ``device`` and its
    input (CPU logits)."""
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    if chain == "cascl8_pc":
        rng = np.random.default_rng(19)
        u = rng.integers(0, 2, (1024, 19)).astype(np.float32)
        c = Polar5GEncoder(19, 864, device="cpu")(torch.from_numpy(u))
        logits = torch.from_numpy((2.0 * ((2.0 * c.numpy() - 1.0) + rng.normal(
            0, 2.0, c.shape)) / 4.0).astype(np.float32))
        return Polar5GDecoder(Polar5GEncoder(19, 864, device=device),
                              dec_type="SCL", list_size=8,
                              mode="exact"), logits
    frozen, _ = generate_5g_ranking(512, 1024)
    kw = (dict(use_fast_scl=True, fast_rate1=True) if chain == "fast_scl8"
          else dict(use_fast_scl=False, lower_stages=8))
    return (PolarSCLDecoder(frozen, 1024, list_size=8, device=device, **kw),
            _logits(1024, 2048, 18))


@pytest.mark.gpu
@pytest.mark.parametrize("chain", ["fast_scl8", "cascl8_pc",
                                   "plain_scl8_b8"])
def test_butterfly_once_a_decode_on_card(cuda, chain, monkeypatch):
    """One decode of each main chain (fast SCL-8, the whole tree in one
    call; CA-SCL-8 with PC bits; plain SCL-8 at b=8, four stacked int8
    subtrees) launches ``butterfly_rows`` once. Its decisions equal the
    same card decode with the plain transform, bit for bit, and the same
    decoder's on CPU tensors on the blocks the SCL kernel decodes alike."""
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_butterfly import butterfly_rows_plain
    dec, logits = _butterfly_chain(chain, cuda)
    want_cpu = _butterfly_chain(chain, "cpu")[0](logits)
    dec(logits.to(cuda))                      # builds and loads the kernels
    torch.cuda.synchronize()
    before = tracing.counter("launch.butterfly_rows")
    got = dec(logits.to(cuda))
    torch.cuda.synchronize()
    assert tracing.counter("launch.butterfly_rows") == before + 1
    monkeypatch.setattr(scan_core, "butterfly_rows", butterfly_rows_plain)
    assert torch.equal(got, dec(logits.to(cuda)))
    assert tracing.counter("launch.butterfly_rows") == before + 1
    agree = (got.cpu() == want_cpu).all(dim=1).float().mean().item()
    assert agree >= BLOCK_AGREEMENT


# sha256 of the decode kernel's outputs (cw, P and the path metrics' bits)
# on each quad case's inputs, as the kernel gave them with the scalar
# [row][codeword][slot] workspaces, before they became row quads
QUAD_CARD_DIGESTS = {
    "scl8_fast_b10": "d60d8ba81a4bc17e",
    "uci_pc_b8": "41c6e2ef3bd22252",
    "traced_L32_b8": "69f443b77f82fab5",
}
QUAD_CARD_COLUMNS = 2051      # no block's codeword count divides it


def _quad_card_case(case):
    """(ops, b, L, mode, frz) of the quad layout's card cases: scl8's fast
    schedule at b=10, the uplink (19, 864) code's PC leaf schedule at b=8
    and the traced form at L=32, b=8 (5G k=128 n=256 frozen flags)."""
    from polar_torch.models.polar.encode import Polar5GEncoder
    if case == "scl8_fast_b10":
        units, _ = split_fast_schedule(_mask_5g(512, 1024), 10, rate1=True)
        return units[0][2], 10, 8, "minsum", None
    if case == "uci_pc_b8":
        enc = Polar5GEncoder(19, 864, device="cpu")
        mask = np.zeros(enc.n_polar, bool)
        mask[enc.frozen_pos] = True
        pc = np.zeros(enc.n_polar, bool)
        pc[enc.pc_pos] = True
        return tuple(leaf_schedule(mask, pc)), 8, 8, "exact", None
    frz = torch.from_numpy(_mask_5g(128, 256).astype(np.int32))
    return traced_schedule(8), 8, 32, "exact", frz


def _digest(out):
    import hashlib
    cw, P, pm = (x.cpu().numpy() for x in out)
    return hashlib.sha256(cw.tobytes() + P.tobytes()
                          + pm.view(np.int32).tobytes()).hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["scl8_fast_b10", "uci_pc_b8",
                                  "traced_L32_b8"])
def test_quad_kernel_on_card(cuda, case):
    """The row-quad kernel on 2051 columns with no stage, the budget's and
    (where a block fits) every stage in shared memory: the same bits at
    every split, equal to the scalar-layout kernel's outputs
    (``QUAD_CARD_DIGESTS``) and to the plain version (min-sum: every
    block)."""
    from polar_torch.models.polar.cuda_scl import (block_smem_bytes,
                                                   shared_stages)
    ops, b, L, mode, frz = _quad_card_case(case)
    rng = np.random.default_rng(b + L)
    bs = QUAD_CARD_COLUMNS
    a = torch.from_numpy(rng.normal(0, 3, (1 << b, L, bs)).astype(
        np.float32)).to(cuda)
    pm = torch.from_numpy(rng.exponential(2.0, (L, bs)).astype(
        np.float32)).to(cuda)
    frz = None if frz is None else frz.to(cuda)
    kw = dict(b=b, llr_max=LLR_MAX, mode=mode, frz=frz)
    sched = SubtreeSchedule(ops, cuda)
    splits = {0, shared_stages(b, L)}
    if block_smem_bytes(L, b) <= 232448:      # a block's shared memory
        splits.add(b)
    outs = [scl_subtree(a, pm, sched, n_shared=n, **kw)
            for n in sorted(splits)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))
    assert _digest(outs[0]) == QUAD_CARD_DIGESTS[case]
    want = scl_subtree_plain(a, pm, ops, **kw)
    share, _ = assert_blocks_agree(
        tuple(x.cpu().numpy() for x in want[:2]),
        tuple(x.cpu().numpy() for x in outs[0][:2]),
        want[2].cpu().numpy(), outs[0][2].cpu().numpy())
    assert mode == "exact" or share == 1.0


def _front_model(n, k, device, seed=0):
    """A plain chain's ``SystemAWGNModel`` (no decoder): the 5G-ranked code
    up to n = 1024, a random frozen set beyond."""
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.models.systems import SystemAWGNModel
    if n <= 1024:
        frozen = generate_5g_ranking(k, n)[0]
    else:
        rng = np.random.default_rng(seed)
        frozen = np.sort(rng.choice(n, n - k, replace=False))
    return SystemAWGNModel(n, k, PolarEncoder(frozen, n, device=device),
                           None)


def _f32_bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,bs", [(1024, 512, 65536), (32, 16, 4099),
                                    (128, 64, 4099), (4096, 2048, 1031)])
def test_qpsk_front_path_equals_composed_chain_on_card(cuda, n, k, bs):
    """The kernel path's ``(bits, codewords, llr)`` equal the composed
    chain's bit for bit on the same seed (at the benchmark cells' shape and
    at n = 32, 128, 4096 on ragged batches), one launch a front, and the
    generator left where the composed chain leaves it."""
    model = _front_model(n, k, cuda, seed=n)
    composed = _front_model(n, k, cuda, seed=n)
    composed._transmit = None
    assert model._transmit is not None
    seed = 3000000017 + n
    gen = torch.Generator(cuda).manual_seed(seed)
    before = tracing.counter("launch.qpsk_front")
    got = model.front(gen, bs, 2.0)
    torch.cuda.synchronize()
    assert tracing.counter("launch.qpsk_front") == before + 1
    want_gen = torch.Generator(cuda).manual_seed(seed)
    want = composed.front(want_gen, bs, 2.0)
    assert tracing.counter("launch.qpsk_front") == before + 1
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype == torch.float32
        assert torch.equal(_f32_bits(x), _f32_bits(y))
    assert torch.equal(gen.get_state(), want_gen.get_state())
    assert torch.equal(torch.randn(4, generator=gen, device=cuda),
                       torch.randn(4, generator=want_gen, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 256, 1024, 2048, 4096])
def test_qpsk_front_kernel_equals_plain_on_card(cuda, n):
    """The wrapper on CUDA tensors against its plain version on the same
    tensors, random frozen sets, a batch no tile divides."""
    from polar_torch.models.polar.cuda_front import (
        qpsk_front, qpsk_front_plain, transmit_plan)
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.ops.ebno import ebnodb2no
    from polar_torch.ops.mapping import Constellation
    rng = np.random.default_rng(n)
    k = int(rng.integers(1, n + 1))
    frozen = np.sort(rng.choice(n, n - k, replace=False))
    table, a = transmit_plan(PolarEncoder(frozen, n, device=cuda),
                             Constellation(2, device=cuda), cuda)
    gen = torch.Generator(cuda).manual_seed(n)
    bs = 1031
    bits = torch.randint(0, 2, (bs, k), generator=gen,
                         device=cuda).float()
    xr, xi = (torch.randn((bs, n // 2), generator=gen, device=cuda)
              for _ in range(2))
    no = ebnodb2no(0.5, 2, k / n)
    got = qpsk_front(bits, xr, xi, table, a, no)
    want = qpsk_front_plain(bits, xr, xi, table, a, no)
    for x, y in zip(got, want):
        assert torch.equal(_f32_bits(x), _f32_bits(y))


@pytest.mark.gpu
def test_qpsk_front_not_launched_on_the_uci_chain(cuda):
    """The 5G encoder keeps the composed chain: no launch."""
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.systems import SystemAWGNModel
    model = SystemAWGNModel(864, 19, Polar5GEncoder(19, 864, device=cuda),
                            None)
    assert model._transmit is None
    before = tracing.counter("launch.qpsk_front")
    model.front(torch.Generator(cuda).manual_seed(5), 1024, 4.5)
    torch.cuda.synchronize()
    assert tracing.counter("launch.qpsk_front") == before
