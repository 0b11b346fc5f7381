"""BP's bf16 message lattice in polar_torch against polar_tpu: the per-op
bf16 check-node arithmetic against JAX under ``jit``, the plain version
against JAX's bf16 XLA engine (soft outputs and flags bit for bit, min-sum
and exact), the host build of the kernel's bf16 instance against the plain
version, the kernel's portable bf16 rounding against torch's conversion,
and the decoder's behaviours (as ``tests/test_bp.py``'s bf16 test). The
kernel itself is tested on the card in ``test_torch_gpu.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.bp import PolarBPDecoder as JPolarBPDecoder
from polar_tpu.ops.fg import f_exact as j_f_exact
from polar_tpu.ops.fg import f_minsum as j_f_minsum
from polar_tpu.ops.fg import make_scaled_minsum as j_make_scaled_minsum

from _torch_parity import run_both
from polar_torch import from_numpy_state
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.cuda_bp import (bf16_round_host, bp_decode,
                                              bp_decode_host,
                                              bp_decode_plain, launch_plan)
from polar_torch.ops.fg import (f_exact_per_op, f_minsum,
                                scaled_minsum_per_op)
from polar_torch.utils import tracing
from test_torch_bp import EXACT_AGREEMENT, _fixture, _noiseless, _prior

LLR_MAX = 30.0
BF16 = torch.bfloat16


def _bits(x):
    """The 16 bits of each bf16 value of a JAX or torch array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# ----------------------------------------------------------------------
# the check-node arithmetic, one rounding per op
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,msf", [("minsum", 0.9375), ("minsum", 1.0),
                                      ("exact", None)])
def test_pe_functions_equal_jax(mode, msf):
    """The u output f(x, y + z) and the v output f(x, y) + z of a
    processing element on 2^16 random bf16 inputs, bit for bit against
    JAX's bf16 ops under jit."""
    rng = np.random.default_rng(16)
    size = 1 << 16
    x, y = (rng.normal(0, 8, size).astype(np.float32) for _ in range(2))
    z = (rng.normal(0, 8, size)
         * 10.0 ** rng.uniform(-3, 1, size)).astype(np.float32)
    if mode == "exact":
        jf, tf = j_f_exact, f_exact_per_op
    else:
        jf = j_f_minsum if msf == 1.0 else j_make_scaled_minsum(msf)

        def tf(a, b, m):
            return scaled_minsum_per_op(msf, a, b, m)

    want_u, want_v = jax.jit(lambda a, b, c: (jf(a, b + c, LLR_MAX),
                                              jf(a, b, LLR_MAX) + c))(
        *(jnp.asarray(v).astype(jnp.bfloat16) for v in (x, y, z)))
    tx, ty, tz = (torch.from_numpy(v).to(BF16) for v in (x, y, z))
    got_u, got_v = tf(tx, ty + tz, LLR_MAX), tf(tx, ty, LLR_MAX) + tz
    assert got_u.dtype == got_v.dtype == BF16
    np.testing.assert_array_equal(_bits(got_u), _bits(want_u))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    if mode == "minsum" and msf != 1.0:
        # the product rounds on its own: f32 arithmetic rounded once at
        # the end differs often
        once = (msf * f_minsum(tx.float(), ty.float()) + tz.float()).to(BF16)
        assert (_bits(once) != _bits(got_v)).sum() > 1000


# ----------------------------------------------------------------------
# the plain version against JAX's bf16 XLA engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,mode,early_stop,num_iter,check_every", [
    (64, "minsum", True, 7, 2),         # an unchecked remainder sweep
    (64, "minsum", False, 9, 3),
    (256, "minsum", True, 20, 2),
    (64, "exact", True, 7, 2),
    (256, "exact", True, 20, 2),
    (256, "exact", False, 12, 1),
])
def test_plain_equals_jax_bf16_engine(n, mode, early_stop, num_iter,
                                      check_every):
    """Soft outputs (``hard_out=False``) and convergence flags bit-equal to
    JAX's ``_run`` under jit with ``msg_dtype=jnp.bfloat16``."""
    frozen, logits, _ = _fixture(n, n // 2, bs=128, seed=n + num_iter)
    kw = dict(num_iter=num_iter, mode=mode, early_stop=early_stop,
              check_every=check_every, hard_out=False)
    jdec = JPolarBPDecoder(frozen, n, use_pallas=False,
                           msg_dtype=jnp.bfloat16, **kw)
    tdec = PolarBPDecoder(frozen, n, msg_dtype=BF16, device="cpu", **kw)
    want, got = run_both(
        jax.jit(lambda x: jdec._run(x, num_iter, want_done=early_stop)),
        lambda x: tdec._run(x, num_iter, want_done=early_stop), logits)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    # the soft outputs are bf16 values
    np.testing.assert_array_equal(got[0].view(np.int32) & 0xffff, 0)
    if early_stop:
        np.testing.assert_array_equal(got[1], want[1])
        assert 0 < got[1].sum() < len(got[1])


# ----------------------------------------------------------------------
# the host build of the kernel's bf16 instance against the plain version
# ----------------------------------------------------------------------
@pytest.mark.parametrize("lattice", ["shared", "global"])
@pytest.mark.parametrize("n,msf,early_stop,num_iter,check_every", [
    (64, 0.9375, True, 21, 2),
    (128, 1.0, True, 10, 3),
    (256, 0.9375, False, 9, 2),
    # the tiled form's degenerate groups (see test_torch_bp.py)
    (2, 0.9375, True, 7, 2),
    (4, 1.0, True, 9, 3),
    (8, 0.9375, False, 5, 1),
    (16, 0.9375, True, 11, 2),
    (2048, 0.9375, True, 9, 3),
])
def test_host_build_equals_plain_minsum(lattice, n, msf, early_stop,
                                        num_iter, check_every):
    """Min-sum: every LLR and flag bit-equal, with the lattice shared (the
    tiled form) and global."""
    frozen, logits, _ = _fixture(n, n // 2, bs=16 if n == 2048 else 64,
                                 seed=n + 1)
    prior = torch.from_numpy(_prior(frozen, n))
    kw = dict(num_iter=num_iter, check_every=check_every,
              early_stop=early_stop, mode="minsum", msf=msf,
              llr_max=LLR_MAX, return_done=early_stop, msg_dtype=BF16)
    want = bp_decode_plain(torch.from_numpy(-logits.T), prior, **kw)
    got = bp_decode_host(torch.from_numpy(logits).t(), prior,
                         lattice=lattice, negate=True, **kw)
    if early_stop:
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        got, want = got[0], want[0]
    assert got.dtype == torch.float32 and got.shape == (n, logits.shape[0])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


@pytest.mark.parametrize("lattice", ["shared", "global"])
def test_host_build_exact_mode_decisions(lattice):
    """Exact mode (expf/log1pf against torch's exp/log1p before each bf16
    rounding): decisions equal on every block the plain version marks
    converged, and on EXACT_AGREEMENT of all blocks."""
    n = 256
    frozen, logits, _ = _fixture(n, n // 2, ebno_db=2.5, bs=128, seed=9)
    prior = torch.from_numpy(_prior(frozen, n))
    llr = torch.from_numpy(np.ascontiguousarray(-logits.T))
    kw = dict(num_iter=12, check_every=2, early_stop=True, mode="exact",
              msf=0.9375, llr_max=LLR_MAX, return_done=True, msg_dtype=BF16)
    got, _ = bp_decode_host(llr, prior, lattice=lattice, **kw)
    want, done = bp_decode_plain(llr, prior, **kw)
    info = prior.numpy() == 0
    differ = ((got.numpy() <= 0) != (want.numpy() <= 0))[info].any(axis=0)
    assert done.sum() > 0.5 * len(done)
    assert not differ[done.numpy() > 0].any()
    assert differ.mean() <= 1.0 - EXACT_AGREEMENT


def test_portable_rounding_equals_torch():
    """The kernel's bf16 rounding (integer arithmetic on the float's bits,
    g++ build) against ``tensor.to(torch.bfloat16)``: ties to even, signed
    zeros, subnormals, the largest finite values (rounding up to infinity)
    and 10^6 random bit patterns."""
    one = np.float32(1.0)
    ties = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
            2.0 ** -130 * 3, 255.5, 256.5]
    special = np.array(
        [0.0, -0.0, 1.0, -1.0, *ties, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
         1.1754942e-38, np.finfo(np.float32).max, -np.finfo(np.float32).max,
         3.3961776e38, 3.3961775e38, np.inf, -np.inf,
         np.nextafter(one, 2 * one), np.nextafter(one, 0 * one)],
        dtype=np.float32)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 10 ** 6, dtype=np.uint64)
    rand = bits.astype(np.uint32).view(np.float32)
    rand = rand[~np.isnan(rand)]
    for x in (special, rand):
        t = torch.from_numpy(x)
        got = bf16_round_host(t).numpy().view(np.uint32)
        want = t.to(BF16).float().numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
    nan = bf16_round_host(torch.tensor([np.nan, -np.nan]))
    assert (nan.numpy().view(np.uint32) == 0x7fc00000).all()


# ----------------------------------------------------------------------
# the decoder
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["minsum", "exact"])
def test_roundtrip_noiseless(mode):
    frozen, logits, u = _noiseless(128, 64, 16, 21)
    dec = PolarBPDecoder(frozen, 128, num_iter=10, mode=mode,
                         msg_dtype=BF16, device="cpu")
    np.testing.assert_array_equal(dec(logits).numpy(), u.numpy())
    _, done = dec._run(logits, 10, want_done=True)
    assert bool(done.all())


def test_bf16_messages_close_to_f32():
    """The counterpart of ``tests/test_bp.py``'s bf16 test: noiseless
    inputs recovered exactly, and the BER on fixed noisy inputs in the f32
    decoder's class."""
    n, k = 256, 128
    frozen, logits, u = _noiseless(n, k, 32, 5, scale=8.0)
    bf = PolarBPDecoder(frozen, n, num_iter=20, msg_dtype=BF16,
                        device="cpu")
    np.testing.assert_array_equal(bf(logits).numpy(), u.numpy())
    frozen, noisy, u = _fixture(n, k, bs=256, seed=0)
    x = torch.from_numpy(noisy)
    ber_bf = np.mean(bf(x).numpy() != u)
    f32 = PolarBPDecoder(frozen, n, num_iter=20, device="cpu")
    ber_f32 = np.mean(f32(x).numpy() != u)
    assert ber_bf <= max(1.5 * ber_f32, ber_f32 + 0.01), (ber_bf, ber_f32)
    assert ber_bf > 0


@pytest.mark.parametrize("hard_out", [True, False])
def test_two_pass_bit_identical(hard_out):
    frozen, logits, _ = _fixture(128, 64, ebno_db=1.0, bs=96, seed=3)
    kw = dict(num_iter=10, check_every=2, hard_out=hard_out,
              msg_dtype=BF16, device="cpu")
    one = PolarBPDecoder(frozen, 128, **kw)
    two = PolarBPDecoder(frozen, 128, two_pass=True, first_pass_iters=4,
                         min_capacity=8, **kw)
    x = torch.from_numpy(logits)
    _, done = two._run(x, 4, want_done=True)
    assert 0 < int(done.sum()) < len(done)
    np.testing.assert_array_equal(one(x).numpy(), two(x).numpy())
    two.prewarm(32)


def test_wrapper_state_and_plan():
    """The wrapper runs the plain bf16 version on CPU tensors (no launch);
    from_numpy_state carries msg_dtype as a string; the launch plan's
    shared bytes halve with 16-bit messages."""
    frozen, logits, _ = _fixture(64, 32, bs=16, seed=2)
    prior = torch.from_numpy(_prior(frozen, 64))
    kw = dict(num_iter=8, check_every=2, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=LLR_MAX, return_done=True, msg_dtype=BF16)
    before = tracing.counter("launch.bp")
    got = bp_decode(torch.from_numpy(logits).t(), prior, negate=True, **kw)
    assert tracing.counter("launch.bp") == before
    want = bp_decode_plain(torch.from_numpy(-logits.T), prior, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    state = dict(frozen_pos=frozen, n=64, k=32, mode="minsum", llr_max=30.0,
                 decoder="bp", num_iter=8, msf=0.9375, early_stop=True,
                 check_every=2, hard_out=False, msg_dtype="bfloat16")
    dec = from_numpy_state(state, device="cpu").decoder
    assert dec.msg_dtype == BF16
    assert from_numpy_state(dict(state, msg_dtype="float32"),
                            device="cpu").decoder.msg_dtype == torch.float32
    with pytest.raises(ValueError, match="msg_dtype"):
        from_numpy_state(dict(state, msg_dtype="float16"), device="cpu")

    # 16-bit messages at levels 3, 6, 9 and S (16 bytes of padding after
    # every 128), a byte a row and a byte a thread
    assert launch_plan(1024, msg_dtype=BF16) == (128, 6,
                                                 7 * 1152 * 2 + 1152)
    assert launch_plan(2048, msg_dtype=BF16) == (256, 6,
                                                 7 * 2304 * 2 + 2304)
    assert launch_plan(1024, "global", msg_dtype=BF16) == (512, 10, 256)
    with pytest.raises(ValueError, match="msg_dtype"):
        bp_decode_plain(torch.zeros(8, 4), torch.zeros(8),
                        **dict(kw, msg_dtype=torch.float16))
