"""The polar_torch binary channels, the BEC link and the small utilities
against polar_tpu: error shares and LLR values by statistics (within 4
sigma, as ``tests/test_channels.py`` holds JAX's), erasures as the same
signed zeros, gradients through the straight-through estimator, and the
SC and SCL decoders on BEC LLRs against JAX's decoders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.models.no_code import NoDecoder as JNoDecoder
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder
from polar_tpu.models.polar.sc import PolarSCDecoder as JPolarSCDecoder
from polar_tpu.models.polar.scl import PolarSCLDecoder as JPolarSCLDecoder
from polar_tpu.ops import butterfly as jbutterfly
from polar_tpu.ops.channels import (
    BinaryErasureChannel as JBinaryErasureChannel,
    BinarySymmetricChannel as JBinarySymmetricChannel)
from polar_tpu.utils import numerics as jnumerics

from _torch_parity import BLOCK_AGREEMENT
from polar_torch import SystemBECModel, from_numpy_state
from polar_torch.models.no_code import NoDecoder, NoEncoder
from polar_torch.models.polar import scan_core as tsc
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_sc import sc_subtree_host
from polar_torch.models.polar.cuda_scl import scl_subtree_host
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.ops import butterfly as tbutterfly
from polar_torch.ops.channels import (BinaryErasureChannel,
                                      BinarySymmetricChannel, _ste_binarize)
from polar_torch.ops.source import BinarySource
from polar_torch.sim import count_block_errors, sim_ber
from polar_torch.utils import numerics as tnumerics

N_STAT = 50_000


def _within_4_sigma(share, p, n=N_STAT):
    return abs(share - p) <= 4.0 * np.sqrt(p * (1.0 - p) / n)


def _bits(seed, n=N_STAT):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, n).astype(np.float32))


@pytest.mark.parametrize("pe", [0.05, 0.3, 0.5])
def test_bec_llrs_by_statistics(pe):
    x = _bits(0)
    y = BinaryErasureChannel(return_llrs=True, llr_max=20.0)(
        torch.Generator().manual_seed(1), (x, pe)).numpy()
    j = np.asarray(JBinaryErasureChannel(return_llrs=True, llr_max=20.0)(
        jax.random.PRNGKey(1), (jnp.asarray(x.numpy()), pe)))
    for out in (y, j):
        assert _within_4_sigma(np.mean(out == 0.0), pe)
        live = out != 0
        np.testing.assert_array_equal(out[live] > 0, x.numpy()[live] == 1)
        assert set(np.unique(np.abs(out))) <= {0.0, 20.0}
    ternary = BinaryErasureChannel()(torch.Generator().manual_seed(2),
                                     (x, pe)).numpy()
    assert set(np.unique(ternary)) <= {-1.0, 0.0, 1.0}
    assert _within_4_sigma(np.mean(ternary == -1.0), pe)


@pytest.mark.parametrize("bipolar", [False, True])
def test_bec_erasures_are_jax_signed_zeros(bipolar):
    """At pe=1 every bit is erased (a Gumbel draw cannot overcome the
    log(1e-9) prior in f32), at pe=0 none is: both outputs are then fixed
    and must equal JAX's bit for bit, signs of the zeros included."""
    x = _bits(3, 4096)
    if bipolar:
        x = 1.0 - 2.0 * x
    for pe in (1.0, 0.0):
        got = BinaryErasureChannel(return_llrs=True, bipolar_input=bipolar)(
            torch.Generator().manual_seed(4), (x, pe)).numpy()
        want = np.asarray(JBinaryErasureChannel(
            return_llrs=True, bipolar_input=bipolar)(
                jax.random.PRNGKey(4), (jnp.asarray(x.numpy()), pe)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    # an erased binary 0 is -0.0, an erased 1 is +0.0
    got = BinaryErasureChannel(return_llrs=True)(
        torch.Generator(), (torch.tensor([0.0, 1.0]), 1.0)).numpy()
    np.testing.assert_array_equal(np.signbit(got), [True, False])
    np.testing.assert_array_equal(got, [0.0, 0.0])


@pytest.mark.parametrize("pb", [0.02, 0.1, 0.4])
def test_bsc_by_statistics(pb):
    x = _bits(5)
    gen = torch.Generator().manual_seed(6)
    y = BinarySymmetricChannel()(gen, (x, pb)).numpy()
    assert set(np.unique(y)) <= {0.0, 1.0}
    assert _within_4_sigma(np.mean(y != x.numpy()), pb)
    j = np.asarray(JBinarySymmetricChannel()(jax.random.PRNGKey(6),
                                             (jnp.asarray(x.numpy()), pb)))
    assert _within_4_sigma(np.mean(j != x.numpy()), pb)
    llr = BinarySymmetricChannel(return_llrs=True)(gen, (x, pb)).numpy()
    j_llr = np.asarray(JBinarySymmetricChannel(return_llrs=True)(
        jax.random.PRNGKey(7), (jnp.asarray(x.numpy()), pb)))
    # the same +-ln((1 - pb) / pb), bit for bit
    np.testing.assert_array_equal(np.unique(np.abs(llr)),
                                  np.unique(np.abs(j_llr)))
    assert _within_4_sigma(np.mean((llr > 0) != (x.numpy() == 1)), pb)
    bip = BinarySymmetricChannel(bipolar_input=True)(
        gen, (1.0 - 2.0 * x, pb)).numpy()
    assert set(np.unique(bip)) <= {-1.0, 1.0}
    assert _within_4_sigma(np.mean(bip != 1.0 - 2.0 * x.numpy()), pb)


def test_bsc_llrs_clip_and_edges():
    x = torch.zeros(8)
    for pb in (0.0, 1e-30, 1.0):
        got = BinarySymmetricChannel(return_llrs=True, llr_max=30.0)(
            torch.Generator().manual_seed(0), (x, pb)).numpy()
        want = np.asarray(JBinarySymmetricChannel(
            return_llrs=True, llr_max=30.0)(jax.random.PRNGKey(0),
                                            (jnp.zeros(8), pb)))
        np.testing.assert_array_equal(np.unique(np.abs(got)),
                                      np.unique(np.abs(want)))
    with pytest.raises(ValueError):
        BinaryErasureChannel(llr_max=-1.0)


@pytest.mark.parametrize("channel", ["bec", "bsc"])
def test_gradient_flows_through_the_channel(channel):
    pe = torch.tensor(0.3, requires_grad=True)
    ch = (BinaryErasureChannel(return_llrs=True) if channel == "bec"
          else BinarySymmetricChannel(return_llrs=True))
    x = torch.ones(256)
    loss = (ch(torch.Generator().manual_seed(5), (x, pe)) ** 2).sum()
    (grad,) = torch.autograd.grad(loss, pe)
    assert torch.isfinite(grad) and grad.item() != 0.0
    # straight through: hard values forward, the identity backward
    v = torch.tensor([0.2, 0.5, 0.9], requires_grad=True)
    hard = _ste_binarize(v)
    np.testing.assert_array_equal(hard.detach().numpy(), [0.0, 1.0, 1.0])
    (g,) = torch.autograd.grad(hard.sum(), v)
    np.testing.assert_array_equal(g.numpy(), [1.0, 1.0, 1.0])


@pytest.mark.parametrize("shape,num,axis", [((3, 4), 2, -1), ((3, 4), 1, 0),
                                            ((2, 3, 4), 2, 1), ((5,), 3, -2),
                                            ((), 2, 0), ((3, 4), 0, 1)])
def test_insert_dims_and_expand_to_rank_equal_jax(shape, num, axis):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = tnumerics.insert_dims(torch.from_numpy(x), num, axis)
    want = jnumerics.insert_dims(jnp.asarray(x), num, axis)
    assert tuple(got.shape) == want.shape
    for rank in (len(shape), len(shape) + num):
        got = tnumerics.expand_to_rank(torch.from_numpy(x), rank, axis)
        assert tuple(got.shape) == jnumerics.expand_to_rank(
            jnp.asarray(x), rank, axis).shape
    with pytest.raises(ValueError):
        tnumerics.insert_dims(torch.from_numpy(x), -1)
    with pytest.raises(ValueError):
        tnumerics.insert_dims(torch.from_numpy(x), 1, len(shape) + 2)


def test_no_code_source_and_dense_generator_equal_jax():
    llr = np.random.default_rng(0).normal(0, 1, (4, 16)).astype(np.float32)
    llr[0, :3] = [0.0, -0.0, 1e-30]
    got = NoDecoder()(torch.from_numpy(llr))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JNoDecoder()(jnp.asarray(llr))))
    bits = torch.ones(3, 5)
    assert NoEncoder()(bits) is bits
    gen = torch.Generator().manual_seed(0)
    src = BinarySource(dtype=torch.int8)(gen, (4, N_STAT // 4))
    assert src.dtype == torch.int8 and src.shape == (4, N_STAT // 4)
    assert _within_4_sigma(src.float().mean().item(), 0.5)
    for n in (2, 4, 64, 256):
        g = tbutterfly.dense_generator(n)
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, jbutterfly.dense_generator(n))
    with pytest.raises(ValueError):
        tbutterfly.dense_generator(12)


@pytest.mark.parametrize("n", [64, 256])
def test_parity_check_equals_jax(n):
    frozen, _ = generate_5g_ranking(n // 2, n)
    enc = PolarEncoder(frozen, n, device="cpu")
    rng = np.random.default_rng(n)
    c = enc(torch.from_numpy(rng.integers(0, 2, (8, n // 2)).astype(
        np.float32))).numpy()
    c[4:, rng.integers(0, n, 4)] = 1.0 - c[4:, rng.integers(0, n, 4)]
    got = enc.parity_check(torch.from_numpy(c)).numpy()
    want = np.asarray(JPolarEncoder(frozen, n).parity_check(jnp.asarray(c)))
    np.testing.assert_array_equal(got, want)
    assert got[:4].all()


def test_bec_link_decodes_pe_zero_and_through_sim_ber():
    n, k = 128, 64
    frozen, _ = generate_5g_ranking(k, n)
    enc = PolarEncoder(frozen, n, device="cpu")
    model = SystemBECModel(n, k, enc, PolarSCDecoder(frozen, n,
                                                     device="cpu"))
    assert model.device.type == "cpu" and model.coderate == 0.5
    bits, bits_hat = model.step(torch.Generator().manual_seed(0), 256, 0.0)
    assert bits_hat.shape == (256, k)
    assert count_block_errors(bits, bits_hat).item() == 0
    _, bler = sim_ber(model, [0.0, 0.3, 0.6], 128, 2, early_stop=False,
                      verbose=False)
    assert bler[0] == 0.0 and 0.0 < bler[2] <= 1.0 and bler[1] <= bler[2]
    cw = from_numpy_state(dict(frozen_pos=frozen, n=n, k=k, decoder="sc",
                               mode="minsum", llr_max=30.0, channel="bec",
                               cw_estimates=True), device="cpu")
    assert isinstance(cw, SystemBECModel) and cw.cw_estimates
    c, c_hat = cw.step(torch.Generator().manual_seed(1), 4, 0.0)
    assert c.shape == (4, n) and c_hat.shape == (4, k)
    with pytest.raises(ValueError, match="channel"):
        from_numpy_state(dict(frozen_pos=frozen, n=n, k=k, decoder="sc",
                              mode="minsum", llr_max=30.0, channel="bsc"),
                         device="cpu")


def _bec_logits(frozen, n, bs, pe, seed):
    """BEC logits of random codewords: +-100 for received bits, erased
    bits the channel's signed zeros (-0.0 for a 0 bit, +0.0 for a 1)."""
    rng = np.random.default_rng(seed)
    enc = PolarEncoder(frozen, n, device="cpu")
    u = torch.from_numpy(rng.integers(0, 2, (bs, enc.k)).astype(np.float32))
    c = enc(u).numpy()
    erased = (rng.random(c.shape) < pe).astype(np.float32)
    return ((2.0 * c - 1.0) * np.float32(100.0) * (1.0 - erased)).astype(
        np.float32)


def _flip_zero_signs(x):
    return np.where(x == 0, -x, x).astype(np.float32)


@pytest.mark.parametrize("n,pe", [(64, 0.3), (256, 0.45)])
def test_sc_on_bec_llrs_equals_jax(n, pe):
    """Min-sum SC, plain version and host build, bit-equal to JAX's SC on
    BEC logits; -0.0 and +0.0 erasures decide the same bits."""
    frozen, _ = generate_5g_ranking(n // 2, n)
    logits = _bec_logits(frozen, n, 128, pe, n)
    assert np.signbit(logits[logits == 0]).any()
    assert not np.signbit(logits[logits == 0]).all()
    want = np.asarray(JPolarSCDecoder(frozen, n, mode="minsum")(
        jnp.asarray(logits)))
    dec = PolarSCDecoder(frozen, n, device="cpu")
    for x in (logits, _flip_zero_signs(logits)):
        np.testing.assert_array_equal(dec(torch.from_numpy(x)).numpy(), want)

    def host(a, frz, sched, **kw):
        return sc_subtree_host(a.contiguous(), frz, sched, **kw)

    mask = np.zeros(n, bool)
    mask[frozen] = True
    llr_ch = -torch.from_numpy(logits).t().contiguous()
    for b in (3, n.bit_length() - 1):
        u = tsc.sc_sweep_hybrid(llr_ch, mask, lower_stages=b, subtree=host)
        np.testing.assert_array_equal(u.t().numpy()[:, dec.info_pos], want)


def _host_scl_decode(dec, logits):
    """``dec``'s decode with its sweep's subtrees on the host build of the
    CUDA kernel's routine: [bs, n] logits -> [bs, k] decisions."""
    llr_ch = -torch.from_numpy(logits).t().contiguous()
    kw = dict(mode=dec.mode, llr_max=dec.llr_max,
              lower_stages=dec.lower_stages, subtree=scl_subtree_host)
    if dec.use_fast_scl:
        u, pm = tsc.scl_sweep_hybrid_fast(llr_ch, dec._frozen_mask,
                                          dec.list_size,
                                          rate1=dec.fast_rate1, **kw)
    else:
        u, pm = tsc.scl_sweep_hybrid(llr_ch, dec._frozen_mask,
                                     dec.list_size, **kw)
    best = u[dec._info_idx][:, pm.argmin(0), torch.arange(u.shape[-1])]
    return best.t().float().numpy()


@pytest.mark.parametrize("n,pe", [(64, 0.3), (256, 0.45)])
def test_scl_on_bec_llrs_equals_jax(n, pe):
    """SCL-8 as the CLI builds it (min-sum; the fast sweep below n=256, the
    plain one from 256), plain version and host build, on BEC logits
    equals JAX's decoder under the block rule. Erasures give exact
    path-metric ties, which both break alike."""
    frozen, _ = generate_5g_ranking(n // 2, n)
    logits = _bec_logits(frozen, n, 64, pe, n + 1)
    want = np.asarray(JPolarSCLDecoder(frozen, n, 8, mode="minsum")(
        jnp.asarray(logits)))
    dec = PolarSCLDecoder(frozen, n, 8, device="cpu")
    assert dec.use_fast_scl == (n < 256)
    for got in (dec(torch.from_numpy(logits)).numpy(),
                _host_scl_decode(dec, logits)):
        agree = (got == want).all(axis=1).mean()
        assert agree >= BLOCK_AGREEMENT, agree
