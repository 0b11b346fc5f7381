"""The CRC of polar_torch against polar_tpu's: the six polynomials of TS
38.212, their generator matrices, encode and check on the same NumPy words,
and the golden fixtures."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.ops import crc as jcrc
from polar_tpu.utils.numerics import int_mod_2 as j_int_mod_2

from polar_torch.ops import crc as tcrc
from polar_torch.utils.numerics import int_mod_2

from _torch_parity import run_both

DEGREES = list(jcrc.CRC_POLYNOMIALS)


def test_polynomials_equal_reference():
    assert tcrc.CRC_POLYNOMIALS == jcrc.CRC_POLYNOMIALS
    for deg in DEGREES:
        bits_t, len_t = tcrc.crc_polynomial(deg)
        bits_j, len_j = jcrc.crc_polynomial(deg)
        np.testing.assert_array_equal(bits_t, bits_j)
        assert len_t == len_j
    with pytest.raises(ValueError):
        tcrc.crc_polynomial("CRC7")


@pytest.mark.parametrize("deg", DEGREES)
def test_generator_matrix_equals_reference(deg):
    for k in (1, 12, 57, 140):
        np.testing.assert_array_equal(tcrc.crc_generator_matrix(k, deg),
                                      jcrc.crc_generator_matrix(k, deg))


@pytest.mark.parametrize("deg", DEGREES)
def test_encoder_equals_reference_and_fixture(crc_fix, deg):
    bits = crc_fix[f"{deg}_in"]
    want = crc_fix[f"{deg}_out"]
    k = bits.shape[-1]
    j_out, t_out = run_both(jcrc.CRCEncoder(deg, k=k),
                            tcrc.CRCEncoder(deg, k=k), bits)
    np.testing.assert_array_equal(t_out, want)
    np.testing.assert_array_equal(t_out, j_out)
    assert t_out.dtype == np.float32


@pytest.mark.parametrize("deg", DEGREES)
def test_decoder_equals_reference(deg):
    """Valid words pass, words with one flipped bit fail, and random words
    get the reference's verdict; the info part is stripped alike."""
    rng = np.random.default_rng(DEGREES.index(deg))
    k = 40
    t_enc = tcrc.CRCEncoder(deg, k=k)
    t_dec = tcrc.CRCDecoder(t_enc)
    j_dec = jcrc.CRCDecoder(jcrc.CRCEncoder(deg, k=k))
    words = t_enc(torch.from_numpy(
        rng.integers(0, 2, (16, k)).astype(np.float32))).numpy()
    flipped = words.copy()
    rows, cols = np.arange(16), rng.integers(0, words.shape[1], 16)
    flipped[rows, cols] = 1.0 - flipped[rows, cols]
    noise = rng.integers(0, 2, (64, words.shape[1])).astype(np.float32)
    for batch, verdict in ((words, True), (flipped, False), (noise, None)):
        (info_j, ok_j), (info_t, ok_t) = run_both(j_dec, t_dec, batch)
        np.testing.assert_array_equal(info_t, info_j)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t.dtype == np.bool_ and ok_t.shape == (len(batch), 1)
        if verdict is not None:
            assert (ok_t == verdict).all()


def test_crc_checks_every_path_of_a_list():
    """The CA-SCL decoder checks [L, bs, k] words in one call."""
    enc = tcrc.CRCEncoder("CRC11", k=20)
    dec = tcrc.CRCDecoder(enc)
    rng = np.random.default_rng(3)
    words = enc(torch.from_numpy(rng.integers(0, 2, (4, 6, 20)).astype(
        np.float32)))
    words[1, 2, 5] = 1 - words[1, 2, 5]
    info, ok = dec(words)
    assert info.shape == (4, 6, 20) and ok.shape == (4, 6, 1)
    assert ok.sum().item() == 23 and not ok[1, 2, 0]


def test_crc_rejects_bad_lengths():
    enc = tcrc.CRCEncoder("CRC6", k=12)
    with pytest.raises(ValueError):
        enc(torch.zeros(2, 13))
    with pytest.raises(ValueError):
        tcrc.CRCDecoder(enc)(torch.zeros(2, 12))
    with pytest.raises(TypeError):
        tcrc.CRCDecoder("CRC6")


def test_int_mod_2_equals_reference():
    x = np.arange(-6, 40, dtype=np.float32).reshape(2, -1)
    j, t = run_both(j_int_mod_2, int_mod_2, x)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.float32
