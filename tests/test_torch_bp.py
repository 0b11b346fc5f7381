"""The polar_torch BP decoder and its kernel against polar_tpu: the scaled
min-sum and its fused multiply-add against JAX, the plain version against
JAX's XLA engine and its Pallas kernel (interpret mode), the host build of
the CUDA kernel's schedule against the plain version, the decoder against
JAX's at k=512 n=1024, and the behaviours of ``tests/test_bp.py``. The
kernel itself is tested on the card in ``test_torch_gpu.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.bp import PolarBPDecoder as JPolarBPDecoder
from polar_tpu.models.polar.pallas_bp import bp_pallas
from polar_tpu.ops.fg import make_scaled_minsum as j_make_scaled_minsum

from _torch_parity import run_both
from polar_torch import from_numpy_state
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.construction import (generate_5g_ranking,
                                                   get_kern_frozen_bits)
from polar_torch.models.polar.cuda_bp import (
    bp_decode, bp_decode_host, bp_decode_plain, launch_plan, resolve_lattice)
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.ops.fg import (fma_f32, make_scaled_minsum,
                                scaled_minsum_add)
from polar_torch.utils import tracing

LLR_MAX = 30.0
# share of blocks whose hard decisions the host build must share with the
# plain version in exact mode (expf/log1pf against torch.logaddexp); on the
# blocks the plain version marks converged they must all agree
EXACT_AGREEMENT = 0.99


def _fixture(n, k, ebno_db=2.0, bs=256, seed=0):
    """(frozen, logits [bs, n], u [bs, k]) of random codewords of the 5G
    k-of-n code (outside the 5G table's n = 32..1024, the RM-style
    construction), QPSK-equivalent BPSK over AWGN at ``ebno_db``."""
    frozen = (generate_5g_ranking(k, n)[0] if 32 <= n <= 1024
              else get_kern_frozen_bits(n, k)[2])
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(bs, k)).astype(np.float32)
    c = PolarEncoder(frozen, n, device="cpu")(torch.from_numpy(u)).numpy()
    sigma = np.sqrt(1.0 / (2 * 10 ** (ebno_db / 10) * (k / n)))
    noisy = (2.0 * c - 1.0) + rng.normal(0, sigma, size=c.shape)
    return frozen, ((2.0 / sigma ** 2) * noisy).astype(np.float32), u


def _prior(frozen, n):
    prior = np.zeros(n, np.float32)
    prior[frozen] = LLR_MAX
    return prior


def _noiseless(n, k, bs, seed, scale=8.0):
    frozen, _ = generate_5g_ranking(k, n)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(bs, k)).astype(np.float32)
    c = PolarEncoder(frozen, n, device="cpu")(torch.from_numpy(u))
    return frozen, scale * (2.0 * c - 1.0), torch.from_numpy(u)


# ----------------------------------------------------------------------
# the check-node arithmetic
# ----------------------------------------------------------------------
@pytest.mark.parametrize("alpha", [0.9375, 0.7])
def test_scaled_minsum_and_fused_add_equal_jax(alpha):
    rng = np.random.default_rng(int(alpha * 16))
    x = rng.normal(0, 8, 100000).astype(np.float32)
    y = rng.normal(0, 8, 100000).astype(np.float32)
    z = (rng.normal(0, 8, 100000)
         * 10.0 ** rng.uniform(-6, 2, 100000)).astype(np.float32)
    jf = j_make_scaled_minsum(alpha)
    want_f = np.asarray(jf(jnp.asarray(x), jnp.asarray(y)))
    want_fz = np.asarray(jax.jit(lambda a, b, c: jf(a, b) + c)(x, y, z))
    tx, ty, tz = (torch.from_numpy(v) for v in (x, y, z))
    got_f = make_scaled_minsum(alpha)(tx, ty).numpy()
    got_fz = scaled_minsum_add(alpha, tx, ty, tz).numpy()
    np.testing.assert_array_equal(got_f.view(np.int32),
                                  want_f.view(np.int32))
    np.testing.assert_array_equal(got_fz.view(np.int32),
                                  want_fz.view(np.int32))
    # the fused form rounds once: two roundings differ on many elements
    assert (got_f + z != want_fz).sum() > 1000


def test_fma_rounds_once_at_f32_midpoints():
    """Sums whose f64 rounding lands on the midpoint of two f32 neighbours
    (a tiny addend below a 28-bit product): a cast of the f64 sum rounds
    twice, XLA's fused multiply-add and ``fma_f32`` once."""
    rng = np.random.default_rng(1)
    b = rng.uniform(1, 2, 3000).astype(np.float32)
    c = (rng.uniform(-1e-9, 1e-9, 3000)
         * 2.0 ** rng.integers(-30, 30, 3000)).astype(np.float32)
    want = np.asarray(jax.jit(lambda b, c: jnp.float32(0.9375) * b + c)(b, c))
    got = fma_f32(0.9375, torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    twice = (0.9375 * b.astype(np.float64) + c).astype(np.float32)
    assert (twice != want).sum() > 0


# ----------------------------------------------------------------------
# the plain version against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,msf,early_stop,num_iter,check_every", [
    (64, 0.9375, True, 20, 2),
    (64, 1.0, True, 21, 3),
    (64, 0.9375, False, 21, 1),
    (128, 0.9375, True, 21, 2),
    (128, 1.0, False, 12, 1),
    (128, 0.9375, True, 12, 3),
    (256, 0.9375, True, 20, 1),
    (256, 1.0, True, 12, 2),
])
def test_plain_equals_jax_engine(n, msf, early_stop, num_iter, check_every):
    """Min-sum: info-side LLRs and convergence flags bit-equal to JAX's
    XLA engine (``_run`` under ``jit``, as the JAX decoder runs it: run
    eagerly, the remainder sweeps would go op by op, unfused)."""
    frozen, logits, _ = _fixture(n, n // 2, bs=128, seed=n + num_iter)
    kw = dict(num_iter=num_iter, msf=msf, early_stop=early_stop,
              check_every=check_every, hard_out=False)
    jdec = JPolarBPDecoder(frozen, n, use_pallas=False, **kw)
    tdec = PolarBPDecoder(frozen, n, device="cpu", **kw)
    want, got = run_both(
        jax.jit(lambda x: jdec._run(x, num_iter, want_done=early_stop)),
        lambda x: tdec._run(x, num_iter, want_done=early_stop), logits)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    if early_stop:
        np.testing.assert_array_equal(got[1], want[1])
        assert 0 < got[1].sum() < len(got[1]) or num_iter < 20


@pytest.mark.parametrize("n,num_iter,early_stop", [(64, 7, True),
                                                   (128, 6, False)])
def test_plain_equals_pallas_interpret(n, num_iter, early_stop):
    """The whole lattice sum and the flags against ``_bp_kernel`` in
    interpret mode (7 sweeps at check_every=2 run the remainder)."""
    frozen, logits, _ = _fixture(n, n // 2, bs=128, seed=n)
    llr = np.ascontiguousarray(-logits.T)
    prior = _prior(frozen, n)
    kw = dict(num_iter=num_iter, check_every=2, early_stop=early_stop,
              mode="minsum", msf=0.9375, llr_max=LLR_MAX)
    want = bp_pallas(jnp.asarray(llr), jnp.asarray(prior),
                     S=n.bit_length() - 1, interpret=True,
                     return_done=early_stop, **kw)
    got = bp_decode_plain(torch.from_numpy(llr), torch.from_numpy(prior),
                          return_done=early_stop, **kw)
    if early_stop:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decoder_equals_jax_k512_n1024():
    """BP-20 at 2.0 dB, the CLI's decoder: soft and hard outputs bit-equal
    to JAX's."""
    n, k = 1024, 512
    frozen, logits, u = _fixture(n, k, bs=256, seed=5)
    want, got = run_both(JPolarBPDecoder(frozen, n, hard_out=False),
                         PolarBPDecoder(frozen, n, hard_out=False,
                                        device="cpu"), logits)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    hard = PolarBPDecoder(frozen, n, device="cpu")(torch.from_numpy(logits))
    np.testing.assert_array_equal(hard.numpy(), (want > 0).astype(np.float32))
    assert 0.0 < (hard.numpy() != u).any(axis=1).mean() < 0.3


def test_from_numpy_state_builds_bp_decoder():
    n, k = 128, 64
    frozen, logits, _ = _fixture(n, k, bs=64, seed=12)
    opts = dict(num_iter=9, msf=0.875, early_stop=True, check_every=3,
                hard_out=True)
    state = dict(frozen_pos=frozen, n=n, k=k, mode="minsum", llr_max=30.0,
                 decoder="bp", **opts)
    model = from_numpy_state(state, device="cpu")
    assert isinstance(model.decoder, PolarBPDecoder) and model.k == k
    assert not model.decoder.two_pass
    want, got = run_both(JPolarBPDecoder(frozen, n, **opts), model.decoder,
                         logits)
    np.testing.assert_array_equal(got, want)
    two = from_numpy_state(dict(state, two_pass=True, first_pass_iters=4),
                           device="cpu").decoder
    assert two.two_pass and two.first_pass_iters == 4
    np.testing.assert_array_equal(two(torch.from_numpy(logits)).numpy(),
                                  want)


# ----------------------------------------------------------------------
# the host build of the kernel's schedule against the plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("lattice", ["shared", "global"])
@pytest.mark.parametrize(
    "n,msf,early_stop,num_iter,check_every", [
        (64, 0.9375, True, 21, 2),
        (256, 1.0, True, 12, 1),
        (256, 0.9375, False, 9, 2),
        (1024, 0.9375, True, 20, 2),
        # the tiled form's groups of three stages: S = 3, 6, 9 end on a
        # whole group; S = 4, 7, 10 on a group of one stage, S = 5, 8, 11
        # on one of two; S = 1, 2 have fewer rows than a thread owns. Odd
        # sweep counts, check_every 1..3
        (8, 0.9375, True, 9, 1),
        (16, 1.0, True, 7, 2),
        (32, 0.9375, False, 5, 1),
        (64, 0.9375, True, 11, 3),
        (128, 0.9375, True, 13, 2),
        (128, 1.0, True, 10, 3),
        (256, 0.9375, True, 15, 1),
        (2, 0.9375, True, 7, 2),
        (2, 1.0, False, 3, 1),
        (4, 0.9375, True, 9, 3),
        (4, 1.0, True, 5, 1),
        (8, 1.0, False, 4, 2),
        (16, 0.9375, True, 13, 3),
        (512, 0.9375, True, 11, 2),
        (2048, 0.9375, True, 13, 3),
        (2048, 1.0, False, 5, 1),
    ])
def test_host_build_equals_plain(lattice, n, msf, early_stop, num_iter,
                                 check_every):
    """Min-sum: bit-equal LLRs and flags. The host build reads the logits
    through a transposed view and negates them on load, with the card's
    launch plan."""
    bs = 32 if n == 1024 else 16 if n == 2048 else 96
    frozen, logits, _ = _fixture(n, n // 2, bs=bs, seed=n)
    prior = torch.from_numpy(_prior(frozen, n))
    kw = dict(num_iter=num_iter, check_every=check_every,
              early_stop=early_stop, mode="minsum", msf=msf,
              llr_max=LLR_MAX, return_done=early_stop)
    want = bp_decode_plain(torch.from_numpy(-logits.T), prior, **kw)
    got = bp_decode_host(torch.from_numpy(logits).t(), prior,
                         lattice=lattice, negate=True, **kw)
    if early_stop:
        assert got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        got, want = got[0], want[0]
    assert got.shape == (n, bs) and got.stride() == (1, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_host_build_global_lattice_at_n4096():
    """Past the 5G table's n=1024: the RM-style construction, and the
    all-zero codeword through AWGN."""
    n = 4096
    _, _, frozen = get_kern_frozen_bits(n, n // 2)
    rng = np.random.default_rng(3)
    llr = torch.from_numpy((3.0 * (1.0 + rng.normal(0, 0.8, (n, 6))))
                           .astype(np.float32))
    prior = torch.from_numpy(_prior(frozen, n))
    kw = dict(num_iter=5, check_every=2, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX, return_done=True)
    assert resolve_lattice(n) == "global"
    got = bp_decode_host(llr, prior, **kw)
    want = bp_decode_plain(llr, prior, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("n,ebno_db,num_iter,check_every", [
    (256, 2.5, 12, 2), (16, 2.5, 9, 3), (2048, 5.5, 7, 1)])
@pytest.mark.parametrize("lattice", ["shared", "global"])
def test_host_build_exact_mode_decisions(lattice, n, ebno_db, num_iter,
                                         check_every):
    """Exact mode rounds differently in expf/log1pf and torch.logaddexp:
    hard decisions must agree on every block the plain version marks
    converged, and on EXACT_AGREEMENT of all blocks (n = 2048: the RM-style
    construction, which BP needs more signal to decode)."""
    frozen, logits, _ = _fixture(n, n // 2, ebno_db=ebno_db,
                                 bs=64 if n == 2048 else 256, seed=9)
    prior = torch.from_numpy(_prior(frozen, n))
    llr = torch.from_numpy(np.ascontiguousarray(-logits.T))
    kw = dict(num_iter=num_iter, check_every=check_every, early_stop=True,
              mode="exact", msf=0.9375, llr_max=LLR_MAX, return_done=True)
    got, _ = bp_decode_host(llr, prior, lattice=lattice, **kw)
    want, done = bp_decode_plain(llr, prior, **kw)
    info = prior.numpy() == 0
    differ = ((got.numpy() <= 0) != (want.numpy() <= 0))[info].any(axis=0)
    assert done.sum() > 0.5 * len(done)
    assert not differ[done.numpy() > 0].any()
    assert differ.mean() <= 1.0 - EXACT_AGREEMENT


# ----------------------------------------------------------------------
# the wrapper and its inputs
# ----------------------------------------------------------------------
def test_wrapper_runs_plain_version_on_cpu():
    frozen, logits, _ = _fixture(64, 32, bs=16, seed=2)
    prior = torch.from_numpy(_prior(frozen, 64))
    kw = dict(num_iter=8, check_every=2, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX, return_done=True)
    before = tracing.counter("launch.bp")
    got = bp_decode(torch.from_numpy(logits).t(), prior, negate=True, **kw)
    assert tracing.counter("launch.bp") == before
    want = bp_decode_plain(torch.from_numpy(-logits.T), prior, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_launch_plan():
    """(threads, CTA barriers a sweep, shared bytes): the tiled form a
    thread per 8 rows (all rows below n = 8), a barrier between two groups
    of three stages in each pass, its padded levels between groups and l_S
    with a byte a row and a byte a thread for the check; the global form's
    512 threads looping over its blocks, a barrier a CTA stage."""
    assert launch_plan(8) == (1, 0, 48)
    assert launch_plan(1024) == (128, 6, 33408)
    assert launch_plan(512) == (64, 4, 5 * 576 * 4 + 512 + 64)
    assert launch_plan(2048) == (256, 6, 66816)
    assert launch_plan(1024, "global") == (512, 10, 256)
    assert launch_plan(4096) == (512, 14, 1024)
    for s in range(1, 12):
        threads, syncs, smem = launch_plan(1 << s)
        assert threads == 1 << max(s - 3, 0)
        assert syncs == 2 * ((s + 2) // 3 - 1)
        assert smem % 16 == 0 and smem <= 227 * 1024


def test_bp_times_needs_the_card(monkeypatch):
    """The tool that times checkouts' BP kernels at the benchmark cell's
    shape refuses to run without a card, as the entry points do."""
    import os
    import sys
    from polar_torch.utils import bp_times
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bp_times.main([os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))])


def test_lattice_choice_and_bad_inputs():
    # l and r at levels 3, 6, 9 and l_S, 16 bytes of padding after every
    # 128; a byte a row and a byte a thread
    assert launch_plan(1024, "shared")[2] == 7 * 1152 * 4 + 1024 + 128
    assert launch_plan(2048, "shared")[2] == 7 * 2304 * 4 + 2048 + 256
    assert resolve_lattice(2048) == "shared"
    assert resolve_lattice(1024, "global") == "global"
    with pytest.raises(ValueError):
        resolve_lattice(4096, "shared")
    with pytest.raises(ValueError):
        resolve_lattice(64, "texture")
    prior = torch.zeros(8)
    kw = dict(num_iter=2, check_every=1, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX)
    with pytest.raises(TypeError):
        bp_decode_host(torch.zeros(8, 4, dtype=torch.float64), prior, **kw)
    with pytest.raises(ValueError):         # 6 rows: not a power of 2
        bp_decode_host(torch.zeros(6, 4), torch.zeros(6), **kw)
    with pytest.raises(ValueError):         # prior of the wrong length
        bp_decode_host(torch.zeros(8, 4), torch.zeros(4), **kw)
    with pytest.raises(ValueError):
        bp_decode_host(torch.zeros(8, 4), prior, **dict(kw, mode="bad"))
    with pytest.raises(ValueError):
        bp_decode(torch.zeros(8, 4), prior, return_done=True,
                  **dict(kw, early_stop=False))
    with pytest.raises(ValueError):
        bp_decode_plain(torch.zeros(8, 4), prior, **dict(kw, num_iter=0))


# ----------------------------------------------------------------------
# the decoder's behaviours (as tests/test_bp.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["minsum", "exact"])
def test_roundtrip_noiseless(mode):
    frozen, logits, u = _noiseless(128, 64, 16, 128)
    dec = PolarBPDecoder(frozen, 128, num_iter=10, mode=mode, device="cpu")
    np.testing.assert_array_equal(dec(logits).numpy(), u.numpy())
    _, done = dec._run(logits, 10, want_done=True)
    assert bool(done.all())


def test_soft_output_sign_and_leading_dims():
    frozen, logits, u = _noiseless(32, 16, 8, 2, scale=6.0)
    soft = PolarBPDecoder(frozen, 32, num_iter=10, hard_out=False,
                          device="cpu")(logits)
    hard = PolarBPDecoder(frozen, 32, num_iter=10, device="cpu")
    # logit convention: positive soft output -> bit 1
    np.testing.assert_array_equal((soft > 0).float().numpy(),
                                  hard(logits).numpy())
    np.testing.assert_array_equal(hard(logits).numpy(), u.numpy())
    out = hard(logits.reshape(2, 4, 32))
    assert out.shape == (2, 4, 16)
    np.testing.assert_array_equal(out.reshape(8, 16).numpy(), u.numpy())


def test_more_sweeps_not_worse():
    frozen, logits, u = _fixture(64, 32, ebno_db=2.0, bs=256, seed=3)
    x = torch.from_numpy(logits)
    blers = [(PolarBPDecoder(frozen, 64, num_iter=it, device="cpu")(x)
              != torch.from_numpy(u)).any(dim=1).float().mean().item()
             for it in (2, 30)]
    assert blers[1] <= blers[0] + 0.05


@pytest.mark.parametrize("hard_out", [True, False])
def test_two_pass_bit_identical(hard_out):
    frozen, logits, _ = _fixture(128, 64, ebno_db=1.0, bs=96, seed=3)
    kw = dict(num_iter=10, check_every=2, hard_out=hard_out, device="cpu")
    one = PolarBPDecoder(frozen, 128, **kw)
    two = PolarBPDecoder(frozen, 128, two_pass=True, first_pass_iters=4,
                         min_capacity=8, **kw)
    x = torch.from_numpy(logits)
    _, done = two._run(x, 4, want_done=True)
    assert 0 < int(done.sum()) < len(done)
    np.testing.assert_array_equal(one(x).numpy(), two(x).numpy())
    assert two._cap_hwm >= 8


def test_two_pass_pipelined_matches_per_batch():
    frozen, logits, _ = _fixture(128, 64, ebno_db=1.0, bs=192, seed=7)
    dec = PolarBPDecoder(frozen, 128, num_iter=8, two_pass=True,
                         first_pass_iters=4, min_capacity=8, device="cpu")
    x = torch.from_numpy(logits)
    outs = dec.decode_pipelined([x[:64], x[64:]], scl_batch=64)
    assert [o.shape[0] for o in outs] == [64, 128]
    for o, b in zip(outs, (x[:64], x[64:])):
        np.testing.assert_array_equal(o.numpy(), dec(b).numpy())
    fresh = PolarBPDecoder(frozen, 128, num_iter=8, two_pass=True,
                           min_capacity=8, device="cpu")
    fresh.prewarm(32, scl_capacity=64)
    assert fresh._cap_hwm == 64


def test_two_pass_all_converged_noiseless():
    frozen, logits, u = _noiseless(64, 32, 32, 11, scale=12.0)
    dec = PolarBPDecoder(frozen, 64, num_iter=10, two_pass=True,
                         first_pass_iters=4, min_capacity=8, device="cpu")
    _, done = dec._run(logits, 4, want_done=True)
    assert bool(done.all())
    np.testing.assert_array_equal(dec(logits).numpy(), u.numpy())


def test_options_and_errors():
    frozen, _ = generate_5g_ranking(32, 64)
    # the JAX package documents f32 and bf16 messages only
    with pytest.raises(ValueError, match="msg_dtype"):
        PolarBPDecoder(frozen, 64, msg_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError):
        PolarBPDecoder(frozen, 64, two_pass=True, early_stop=False,
                       device="cpu")
    with pytest.raises(ValueError):
        PolarBPDecoder(frozen, 48, device="cpu")
    with pytest.raises(ValueError):
        PolarBPDecoder(frozen, 64, mode="bad", device="cpu")
    dec = PolarBPDecoder(frozen, 64, output_dtype=torch.int8,
                         first_pass_iters=50, device="cpu")
    assert dec.first_pass_iters == dec.num_iter == 20
    assert dec(torch.zeros(4, 64)).dtype == torch.int8
    with pytest.raises(ValueError):
        dec(torch.zeros(4, 32))
    with pytest.raises(ValueError):
        dec.decode_pipelined([torch.zeros(4, 64)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PolarBPDecoder(frozen, 64)
