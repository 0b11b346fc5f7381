"""The 5G NR chain of polar_torch against polar_tpu: rate matching, PC bits,
``Polar5GEncoder`` (construction, indices and codewords for every
rate-matching regime, uplink and downlink), ``Polar5GDecoder`` (the golden
SCL-8 fixtures, CA-SCL on shared LLRs, round-trips, CRC status), the 5G
state of ``from_numpy_state`` and ``sim_ber`` over the chain."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar import pc as jpc
from polar_tpu.models.polar import rate_match as jrm
from polar_tpu.models.polar.decode5g import Polar5GDecoder as JPolar5GDecoder
from polar_tpu.models.polar.encode import Polar5GEncoder as JPolar5GEncoder

from _torch_parity import run_both
from polar_torch import (Polar5GDecoder, Polar5GEncoder, SystemAWGNModel,
                         from_numpy_state, sim_ber)
from polar_torch.models.polar import pc as tpc
from polar_torch.models.polar import rate_match as trm

# (k, n, channel_type, enable_pc): the regimes of tests/test_5g.py (and
# the PC payloads 12..19 of tests/test_pc.py)
ENCODER_CASES = [
    (32, 140, "uplink", True),     # repetition
    (20, 90, "uplink", True),      # puncturing
    (40, 100, "uplink", True),     # shortening
    (90, 110, "uplink", True),     # high-rate shortening
    (12, 18, "uplink", True),      # minimum n (no room for PC bits)
    (132, 1088, "uplink", True),   # maximum n
    (400, 1000, "uplink", True),   # the chip's 5G cell
    (64, 200, "uplink", False),
    (30, 120, "downlink", True),
    (140, 576, "downlink", True),
    (25, 50, "downlink", True),
] + [(k, n, "uplink", True) for k, n in ((12, 48), (13, 64), (15, 100),
                                          (16, 64), (17, 250), (19, 256),
                                          (19, 600))]


def _case_id(case):
    k, n, ch, pc = case
    return f"{ch[0]}l_k{k}_n{n}" + ("" if pc else "_nopc")


def test_rate_match_equals_reference():
    for n in (32, 64, 256, 1024):
        np.testing.assert_array_equal(
            trm.subblock_interleaving(np.arange(n)),
            jrm.subblock_interleaving(np.arange(n)))
    for e in (18, 90, 100, 1000, 1088):
        np.testing.assert_array_equal(trm.channel_interleaver(np.arange(e)),
                                      jrm.channel_interleaver(np.arange(e)))
    for k in (1, 49, 164):
        np.testing.assert_array_equal(trm.input_interleaver(np.arange(k)),
                                      jrm.input_interleaver(np.arange(k)))
    with pytest.raises(ValueError):
        trm.subblock_interleaving(np.arange(48))
    with pytest.raises(ValueError):
        trm.input_interleaver(np.arange(165))


def test_pc_helpers_equal_reference():
    rng = np.random.default_rng(0)
    for e, k in ((48, 18), (250, 23), (600, 25)):
        assert tpc.n_pc_wm(e, k) == jpc.n_pc_wm(e, k)
    for wm in (0, 1):
        cand = rng.permutation(64)
        for got, want in zip(tpc.select_pc_positions(cand, 20, 3, wm),
                             jpc.select_pc_positions(cand, 20, 3, wm)):
            np.testing.assert_array_equal(got, want)
    for trial in range(4):
        is_data = rng.random(64) < 0.4
        is_pc = ~is_data & (rng.random(64) < 0.1)
        for got, want in zip(tpc.pc_flags(64, np.flatnonzero(is_data | is_pc),
                                          np.flatnonzero(is_pc)),
                             jpc.pc_flags(64, np.flatnonzero(is_data | is_pc),
                                          np.flatnonzero(is_pc))):
            np.testing.assert_array_equal(got, want)
        u = np.where(is_data, rng.integers(0, 2, (8, 64)), 0).astype(
            np.float32)
        want = np.asarray(jpc.pc_expand(jnp.asarray(u), is_data, is_pc))
        got = tpc.pc_expand(torch.from_numpy(u), is_data, is_pc).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ENCODER_CASES, ids=_case_id)
def test_encoder_equals_reference(case):
    k, n, channel, enable_pc = case
    j_enc = JPolar5GEncoder(k, n, channel_type=channel, enable_pc=enable_pc)
    t_enc = Polar5GEncoder(k, n, channel_type=channel, enable_pc=enable_pc,
                           device="cpu")
    assert (t_enc.k, t_enc.n) == (k, n)
    assert (t_enc.k_polar, t_enc.n_polar) == (j_enc.k_polar, j_enc.n_polar)
    assert t_enc.enc_crc.crc_degree == j_enc.enc_crc.crc_degree
    np.testing.assert_array_equal(t_enc.frozen_pos, j_enc.frozen_pos)
    np.testing.assert_array_equal(t_enc._ind_rate_matching,
                                  j_enc._ind_rate_matching)
    if j_enc.pc_pos is None:
        assert t_enc.pc_pos is None
    else:
        np.testing.assert_array_equal(t_enc.pc_pos, j_enc.pc_pos)
    if channel == "downlink":
        np.testing.assert_array_equal(t_enc._ind_input_int,
                                      j_enc._ind_input_int)
    u = np.random.default_rng(k + n).integers(0, 2, (6, k)).astype(
        np.float32)
    c = t_enc(torch.from_numpy(u))
    assert c.shape == (6, n) and c.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(),
                                  np.asarray(j_enc(jnp.asarray(u))))


def test_encoder_places_pc_bits_for_small_uplink_payloads():
    for k in range(12, 20):
        enc = Polar5GEncoder(k, 64, device="cpu")
        assert enc.pc_pos is not None and len(enc.pc_pos) == 3
        assert enc.enc_crc.crc_degree == "CRC6"
    assert Polar5GEncoder(20, 64, device="cpu").pc_pos is None
    assert Polar5GEncoder(12, 64, enable_pc=False, device="cpu").pc_pos \
        is None


def test_encoder_limits():
    for kwargs in (dict(k=1014, n=1088), dict(k=10, n=17), dict(k=11, n=48),
                   dict(k=141, n=400, channel_type="downlink"),
                   dict(k=20, n=100, channel_type="sidelink")):
        with pytest.raises(ValueError):
            Polar5GEncoder(device="cpu", **kwargs)


@pytest.mark.parametrize("k,n", [(32, 140), (20, 90), (40, 100), (12, 48),
                                 (64, 200)])
def test_scl_decoder_equals_golden_fixture(polar5g_fix, k, n):
    enc = Polar5GEncoder(k, n, enable_pc=False, device="cpu")
    dec = Polar5GDecoder(enc, dec_type="SCL", list_size=8, mode="exact")
    got = dec(torch.from_numpy(polar5g_fix[f"ul_k{k}_n{n}_llr"]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  polar5g_fix[f"ul_k{k}_n{n}_uhat_scl8"])


def _noisy_logits(enc, bs, sigma, seed):
    """(u, logits) of random payloads through ``enc`` over BPSK-AWGN."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (bs, enc.k)).astype(np.float32)
    c = enc(torch.from_numpy(u)).numpy()
    y = (2.0 * c - 1.0) + rng.normal(0, sigma, c.shape)
    return u, ((2.0 / sigma ** 2) * y).astype(np.float32)


@pytest.mark.parametrize("k,n,channel,dec_type,L", [
    (64, 200, "uplink", "SCL", 8),     # plain sweep (n_polar = 256)
    (20, 90, "uplink", "SCL", 32),     # fast sweep, puncturing
    (30, 120, "downlink", "SCL", 8),   # CRC24C after the input interleaver
    (40, 100, "uplink", "SC", 8),
])
def test_decoder_equals_reference_on_shared_llrs(k, n, channel, dec_type, L):
    t_enc = Polar5GEncoder(k, n, channel_type=channel, device="cpu")
    j_enc = JPolar5GEncoder(k, n, channel_type=channel)
    _, logits = _noisy_logits(t_enc, 64, 0.9, seed=k + L)
    kw = dict(dec_type=dec_type, list_size=L, return_crc_status=True)
    (u_j, ok_j), (u_t, ok_t) = run_both(JPolar5GDecoder(j_enc, **kw),
                                        Polar5GDecoder(t_enc, **kw), logits)
    np.testing.assert_array_equal(u_t, u_j)
    np.testing.assert_array_equal(ok_t, ok_j)


@pytest.mark.parametrize("k,n,channel,dec_type", [
    (32, 140, "uplink", "SC"), (20, 90, "uplink", "SC"),
    (40, 100, "uplink", "SC"), (90, 110, "uplink", "SC"),
    (12, 18, "uplink", "SC"), (132, 1088, "uplink", "SC"),
    (32, 140, "uplink", "SCL"), (20, 90, "uplink", "SCL"),
    (40, 100, "uplink", "hybSCL"), (30, 120, "downlink", "SC"),
    (140, 576, "downlink", "SC"), (25, 50, "downlink", "SC"),
    (30, 120, "downlink", "SCL"), (30, 120, "downlink", "hybSCL"),
])
def test_roundtrip(k, n, channel, dec_type):
    enc = Polar5GEncoder(k, n, channel_type=channel, device="cpu")
    dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=4)
    u = np.random.default_rng(k * 1000 + n).integers(0, 2, (4, k)).astype(
        np.float32)
    cw = enc(torch.from_numpy(u))
    u_hat = dec((2.0 * cw - 1.0) * 10.0)
    np.testing.assert_array_equal(u_hat.numpy(), u)


@pytest.mark.parametrize("dec_type", ["SC", "SCL", "hybSCL"])
def test_crc_status(dec_type):
    enc = Polar5GEncoder(40, 100, device="cpu")
    dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=8,
                         return_crc_status=True)
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (6, 40)).astype(np.float32)
    cw = enc(torch.from_numpy(u))
    u_hat, status = dec((2.0 * cw - 1.0)[None] * 10.0)
    assert u_hat.shape == (1, 6, 40) and status.shape == (1, 6)
    np.testing.assert_array_equal(u_hat[0].numpy(), u)
    assert status.dtype == torch.bool and status.all()
    _, bad = dec(torch.from_numpy(rng.normal(0, 0.5, (6, 100)).astype(
        np.float32)))
    assert not bad.all()


def test_decoder_options():
    enc = Polar5GEncoder(40, 100, device="cpu")
    with pytest.raises(ValueError):
        Polar5GDecoder(enc, dec_type="nonsense")
    with pytest.raises(TypeError):
        Polar5GDecoder("not an encoder")
    # a PC code (3 PC bits, CRC6) decodes: its PC positions leave the
    # decoder's output, and the whole tree is one subtree
    pc_enc = Polar5GEncoder(16, 64, device="cpu")
    pc_dec = Polar5GDecoder(pc_enc, dec_type="SCL")
    assert pc_dec._polar_dec.k == 16 + 6 and pc_dec._polar_dec.lower_stages == 6
    np.testing.assert_array_equal(pc_dec._polar_dec.pc_pos, pc_enc.pc_pos)
    u = torch.ones(2, 16)
    np.testing.assert_array_equal(pc_dec(10.0 * (2.0 * pc_enc(u) - 1.0)), u)
    dec = Polar5GDecoder(enc, dec_type="SCL", list_size=32, lower_stages=3)
    assert dec._polar_dec.lower_stages == 3
    with pytest.raises(ValueError):      # decode_pipelined is hybSCL's
        dec.decode_pipelined([torch.zeros(2, 100)])


def test_from_numpy_state_5g_builds_the_jax_chain():
    j_enc = JPolar5GEncoder(40, 100)
    state = dict(code="5g", k=40, n=100, channel_type="uplink",
                 enable_pc=True, dec_type="SCL", list_size=8, mode="exact",
                 use_fast_scl=None, frozen_pos=np.asarray(j_enc.frozen_pos))
    model = from_numpy_state(state, device="cpu")
    assert isinstance(model.encoder, Polar5GEncoder)
    assert isinstance(model.decoder, Polar5GDecoder)
    assert (model.k, model.n) == (40, 100)
    u, logits = _noisy_logits(model.encoder, 32, 0.8, seed=2)
    np.testing.assert_array_equal(
        model.encoder(torch.from_numpy(u)).numpy(),
        np.asarray(j_enc(jnp.asarray(u))))
    # the decoder against JAX's: test_decoder_equals_reference_on_shared_llrs
    direct = Polar5GDecoder(model.encoder, dec_type="SCL", list_size=8,
                            mode="exact")
    assert model.decoder._polar_dec.mode == "exact"
    assert torch.equal(model.decoder(torch.from_numpy(logits)),
                       direct(torch.from_numpy(logits)))
    with pytest.raises(ValueError, match="frozen_pos"):
        from_numpy_state(dict(state, frozen_pos=np.arange(10)),
                         device="cpu")


@pytest.mark.parametrize("dec_type", ["SC", "SCL", "hybSCL"])
def test_sim_ber_runs_the_5g_chain(dec_type):
    enc = Polar5GEncoder(40, 100, device="cpu")
    dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=8)
    model = SystemAWGNModel(100, 40, enc, dec)
    ber, bler = sim_ber(model, [1.0, 6.0], batch_size=64, max_mc_iter=2,
                        verbose=False, early_stop=False, seed=1)
    assert ber.shape == bler.shape == (2,)
    assert 0.0 < bler[0] <= 1.0 and bler[1] <= bler[0]
    assert ((0.0 <= ber) & (ber <= bler)).all()
