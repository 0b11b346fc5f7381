"""The polar_torch kernel zoo and dense-G chain against polar_tpu's: every
kernel of ``KERNELS``, the GF(2) inverse, the dense encoder bit for bit and
the OSD-based dense decoder under the tie rule, and the ``code="dense"``
state of ``from_numpy_state``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar import kernels as jkernels
from polar_tpu.models.polar.construction import (
    get_kern_frozen_bits as j_get_kern_frozen_bits)
from polar_tpu.models.polar.dense import (
    DenseKernelDecoder as JDenseKernelDecoder,
    DenseKernelEncoder as JDenseKernelEncoder, gf2_inv as j_gf2_inv)

from _torch_parity import assert_osd_agrees
from polar_torch import from_numpy_state
from polar_torch.models.polar import kernels as tkernels
from polar_torch.models.polar.construction import get_kern_frozen_bits
from polar_torch.models.polar.dense import (DenseKernelDecoder,
                                            DenseKernelEncoder, gf2_inv)
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.kernels import KERNELS, get_kernel


def test_zoo_equals_jax():
    assert list(KERNELS) == list(jkernels.KERNELS)
    for name, kern in KERNELS.items():
        want = jkernels.KERNELS[name]
        assert kern.dtype == want.dtype, name
        np.testing.assert_array_equal(kern, want, err_msg=name)
        np.testing.assert_array_equal(get_kernel(name.lower()), want)
        np.testing.assert_array_equal(tkernels.row_weights(kern),
                                      jkernels.row_weights(want))
    for n in (2, 4, 16, 32):
        for fn in ("arikan_power", "bit_reversed_kernel",
                   "weight_sorted_kernel"):
            np.testing.assert_array_equal(getattr(tkernels, fn)(n),
                                          getattr(jkernels, fn)(n))
    get_kernel("G16")[0, 0] = 7          # a copy: the zoo stays as it is
    assert KERNELS["G16"][0, 0] == 1
    with pytest.raises(KeyError, match="unknown kernel"):
        get_kernel("F3")
    with pytest.raises(ValueError):
        tkernels.arikan_power(12)


def test_gf2_inv_equals_jax():
    for name, kern in KERNELS.items():
        inv = gf2_inv(kern)
        np.testing.assert_array_equal(inv, j_gf2_inv(kern), err_msg=name)
        np.testing.assert_array_equal(
            (np.asarray(kern, np.int64) @ inv) % 2,
            np.eye(kern.shape[0], dtype=np.int64))
    with pytest.raises(ValueError, match="singular"):
        gf2_inv(np.array([[1, 1], [1, 1]]))
    with pytest.raises(ValueError):
        gf2_inv(np.ones((2, 3)))


def _code(name, n):
    kern = get_kernel(name)
    _, _, frozen = get_kern_frozen_bits(n, n // 2, kern)
    np.testing.assert_array_equal(
        frozen, j_get_kern_frozen_bits(n, n // 2, kern)[2])
    return kern, frozen


@pytest.mark.parametrize("name,n", [("F2", 64), ("F4", 16), ("G8", 64),
                                    ("K16", 256), ("G16", 256)])
def test_dense_encoder_equals_jax(name, n):
    kern, frozen = _code(name, n)
    enc = DenseKernelEncoder(frozen, n, kern, device="cpu")
    u = np.random.default_rng(n).integers(0, 2, (16, enc.k)).astype(
        np.float32)
    got = enc(torch.from_numpy(u))
    assert got.dtype == torch.float32 and got.shape == (16, n)
    want = JDenseKernelEncoder(frozen, n, kern)(jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(enc.info_pos,
                                  JDenseKernelEncoder(frozen, n, kern).info_pos)
    # codewords pass the parity check; one flipped bit fails it
    bad = got.clone()
    bad[:, 0] = 1.0 - bad[:, 0]
    assert bool(enc.parity_check(got).all())
    assert not bool(enc.parity_check(bad).any())
    np.testing.assert_array_equal(enc.info_bits(got)[:, enc.info_pos], u)
    if name == "F2":        # the dense chain of F2 is the butterfly's
        polar = PolarEncoder(frozen, n, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), polar(torch.from_numpy(u)).numpy())
        np.testing.assert_array_equal(enc.parity_check(bad).numpy(),
                                      polar.parity_check(bad).numpy())
    with pytest.raises(ValueError):
        enc(torch.zeros(2, enc.k + 1))


@pytest.mark.parametrize("name,n,t", [("G16", 16, 2), ("K8", 64, 1),
                                      ("F4", 16, 2)])
def test_dense_decoder_equals_jax(name, n, t):
    kern, frozen = _code(name, n)
    enc = DenseKernelEncoder(frozen, n, kern, device="cpu")
    dec = DenseKernelDecoder(enc, t=t)
    j_enc = JDenseKernelEncoder(frozen, n, kern)
    j_dec = JDenseKernelDecoder(j_enc, t=t)
    rng = np.random.default_rng(n + t)
    u = rng.integers(0, 2, (16, enc.k)).astype(np.float32)
    c = enc(torch.from_numpy(u)).numpy()
    llr = ((2.0 * c - 1.0) * 2.0 + rng.normal(0, 1.5, c.shape)).astype(
        np.float32)
    got = dec(torch.from_numpy(llr)).numpy()
    want = np.asarray(j_dec(jnp.asarray(llr)))
    # the decoders agree where their OSD codewords do; a differing block
    # must be a distance tie of the codewords
    c_got = dec._osd(torch.from_numpy(llr)).numpy()
    c_want = np.asarray(j_dec._osd(jnp.asarray(llr)))
    assert_osd_agrees(llr, c_got, c_want, llr_max=100.0)
    same = ~(c_got != c_want).any(axis=1)
    np.testing.assert_array_equal(got[same], want[same])
    # noiseless logits round-trip the info bits
    np.testing.assert_array_equal(
        dec(torch.from_numpy(8.0 * (2.0 * c - 1.0))).numpy(), u)
    assert (dec.k, dec.n) == (enc.k, n)


def test_from_numpy_state_dense_decodes_like_jax():
    n, t = 16, 1
    kern, frozen = _code("K16", n)
    model = from_numpy_state(dict(code="dense", kern=kern, frozen_pos=frozen,
                                  n=n, k=n // 2, osd_t=t, pattern_chunk=3,
                                  llr_max=100.0), device="cpu")
    assert isinstance(model.encoder, DenseKernelEncoder)
    j_dec = JDenseKernelDecoder(JDenseKernelEncoder(frozen, n, kern), t=t,
                                pattern_chunk=3)
    assert model.decoder._osd._pattern_chunks.shape == (3, 3, 1)
    np.testing.assert_array_equal(model.decoder._osd._pattern_chunks,
                                  j_dec._osd._pattern_chunks)
    llr = np.random.default_rng(8).normal(0, 3, (32, n)).astype(np.float32)
    c_got = model.decoder._osd(torch.from_numpy(llr)).numpy()
    c_want = np.asarray(j_dec._osd(jnp.asarray(llr)))
    assert assert_osd_agrees(llr, c_got, c_want, llr_max=100.0) == 0
    np.testing.assert_array_equal(model.decoder(torch.from_numpy(llr)).numpy(),
                                  np.asarray(j_dec(jnp.asarray(llr))))
    bits, bits_hat = model.step(torch.Generator().manual_seed(0), 64, 8.0)
    assert bits_hat.shape == (64, n // 2)
    assert not (bits != bits_hat).any()
