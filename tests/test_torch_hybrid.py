"""The hybrid SC -> CA-SCL decoder of polar_torch against polar_tpu's and
against the port's own full-batch CA-SCL.

The invariant (as in ``tests/test_hybrid.py``): every decoder of the chain
treats each codeword on its own, so the compacted CA-SCL re-decode of the
rows whose SC output fails the CRC is bit-identical to a full-batch CA-SCL
decode of those rows, and every SC-accepted row passes the CRC."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.hybrid import HybridSCLDecoder as JHybrid
from polar_tpu.ops.crc import CRCEncoder as JCRCEncoder

from _torch_parity import run_both
from polar_torch import (HybridSCLDecoder, Polar5GDecoder, Polar5GEncoder,
                         PolarEncoder, PolarSCLDecoder, SystemAWGNModel,
                         generate_5g_ranking, sim_ber)
from polar_torch.ops.crc import CRCEncoder, crc_polynomial

DEG = "CRC11"


def _crc_batch(n, k, ebno_db, bs, seed=0):
    """(frozen, logits, u) with valid CRC payloads at ``ebno_db``, made
    with numpy and the port's CRC and encoder."""
    frozen, _ = generate_5g_ranking(k, n)
    _, crc_len = crc_polynomial(DEG)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (bs, k - crc_len)).astype(np.float32)
    u = CRCEncoder(DEG, k=k - crc_len)(torch.from_numpy(payload))
    c = PolarEncoder(frozen, n, device="cpu")(u).numpy()
    sigma = np.sqrt(1.0 / (2 * 10 ** (ebno_db / 10) * (k / n)))
    noisy = (2.0 * c - 1.0) + rng.normal(0, sigma, c.shape)
    return frozen, ((2.0 / sigma ** 2) * noisy).astype(np.float32), u.numpy()


def _sc_accepts(hyb, logits):
    return hyb._sc_crc(torch.from_numpy(logits))[1].numpy()


@pytest.mark.parametrize("n,k,ebno_db,cap", [(64, 32, 1.0, 4),
                                             (256, 128, 1.5, 8)])
def test_failed_blocks_bit_equal_full_batch_ca_scl(n, k, ebno_db, cap):
    """n=64 runs the fast sweep, n=256 the plain one."""
    frozen, logits, _ = _crc_batch(n, k, ebno_db, 256 if n == 64 else 128,
                                   seed=n)
    hyb = HybridSCLDecoder(frozen, n, list_size=8, crc_degree=DEG,
                           min_capacity=cap, return_crc_status=True,
                           device="cpu")
    scl = PolarSCLDecoder(frozen, n, list_size=8, crc_degree=DEG,
                          return_crc_status=True, device="cpu")
    out_h, st_h = hyb(torch.from_numpy(logits))
    out_s, st_s = scl(torch.from_numpy(logits))
    ok = _sc_accepts(hyb, logits)
    assert 0 < ok.sum() < len(ok), "the batch must mix SC passes and fails"
    np.testing.assert_array_equal(out_h.numpy()[~ok], out_s.numpy()[~ok])
    np.testing.assert_array_equal(st_h.numpy()[~ok], st_s.numpy()[~ok])
    assert st_h.numpy()[ok].all()


def test_hybrid_equals_reference():
    n, k = 64, 32
    frozen, logits, _ = _crc_batch(n, k, 1.0, 256, seed=2)
    kw = dict(list_size=8, crc_degree=DEG, min_capacity=4,
              return_crc_status=True)
    (u_j, st_j), (u_t, st_t) = run_both(
        JHybrid(frozen, n, **kw),
        HybridSCLDecoder(frozen, n, device="cpu", **kw), logits)
    np.testing.assert_array_equal(u_t, u_j)
    np.testing.assert_array_equal(st_t, st_j)


def test_crc_batches_equal_reference_crc():
    """The test inputs' CRC words equal the JAX package's for the same
    payload (the helper above uses the port's CRC)."""
    _, _, u = _crc_batch(64, 32, 1.0, 8, seed=4)
    want = JCRCEncoder(DEG, k=21)(jnp.asarray(u[:, :21]))
    np.testing.assert_array_equal(u, np.asarray(want))


def test_noiseless_blocks_take_the_sc_path():
    n, k = 64, 32
    frozen, logits, u = _crc_batch(n, k, 30.0, 32)
    hyb = HybridSCLDecoder(frozen, n, list_size=8, crc_degree=DEG,
                           device="cpu")
    out = hyb(torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), u)
    assert _sc_accepts(hyb, logits).all()


def test_capacity_buckets_keep_their_high_water_mark():
    frozen, _ = generate_5g_ranking(32, 64)
    hyb = HybridSCLDecoder(frozen, 64, crc_degree=DEG, min_capacity=4,
                           device="cpu")
    assert [hyb._capacity(f, 64) for f in (1, 4, 5, 3, 40, 2)] == \
        [4, 4, 8, 8, 64, 64]
    hyb = HybridSCLDecoder(frozen, 64, crc_degree=DEG, min_capacity=128,
                           device="cpu")
    assert hyb._capacity(3, 16) == 16     # never more than the batch
    rows = hyb._rows(np.array([5, 9]), 16).tolist()
    assert rows[:2] == [5, 9] and set(rows[2:]) == {5} and len(rows) == 16


def test_scl_constructor_delegates_hybrid():
    n, k = 64, 32
    frozen, logits, _ = _crc_batch(n, k, 1.0, 64, seed=1)
    via_flag = PolarSCLDecoder(frozen, n, list_size=8, crc_degree=DEG,
                               use_hybrid_sc=True, device="cpu")
    direct = HybridSCLDecoder(frozen, n, list_size=8, crc_degree=DEG,
                              device="cpu")
    np.testing.assert_array_equal(
        via_flag(torch.from_numpy(logits)).numpy(),
        direct(torch.from_numpy(logits)).numpy())
    with pytest.raises(ValueError):       # the SC accept test needs a CRC
        PolarSCLDecoder(frozen, n, use_hybrid_sc=True, device="cpu")


def _5g_logits(enc, bs, seed, sigma=0.85):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (bs, enc.k)).astype(np.float32)
    c = enc(torch.from_numpy(u)).numpy()
    y = (2.0 * c - 1.0) + rng.normal(0, sigma, c.shape)
    return u, ((2.0 / sigma ** 2) * y).astype(np.float32)


def test_polar5g_hybscl_equals_ca_scl_on_sc_failures():
    enc = Polar5GEncoder(64, 128, device="cpu")
    dec_h = Polar5GDecoder(enc, dec_type="hybSCL", list_size=8,
                           return_crc_status=True)
    dec_s = Polar5GDecoder(enc, dec_type="SCL", list_size=8,
                           return_crc_status=True)
    u, logits = _5g_logits(enc, 128, seed=7)
    uh, _ = dec_h(torch.from_numpy(logits))
    us, _ = dec_s(torch.from_numpy(logits))
    ok = dec_h._polar_dec._sc_crc(dec_h.rate_recover(
        torch.from_numpy(logits)))[1].numpy()
    assert (~ok).sum() > 0
    np.testing.assert_array_equal(uh.numpy()[~ok], us.numpy()[~ok])
    bler_h = np.mean((uh.numpy() != u).any(axis=1))
    bler_s = np.mean((us.numpy() != u).any(axis=1))
    assert bler_h <= bler_s + 0.03


def test_pipelined_equals_per_batch():
    n, k = 64, 32
    hyb = HybridSCLDecoder(_crc_batch(n, k, 1.0, 8)[0], n, list_size=8,
                           crc_degree=DEG, min_capacity=4,
                           return_crc_status=True, device="cpu")
    batches = [torch.from_numpy(_crc_batch(n, k, 1.0, bs, seed=s)[1])
               for bs, s in ((48, 11), (64, 12), (16, 13))]
    piped = hyb.decode_pipelined(batches, scl_batch=32)
    for llr, (u_p, st_p) in zip(batches, piped):
        u_c, st_c = hyb(llr)
        assert torch.equal(u_p, u_c) and torch.equal(st_p, st_c)


def test_polar5g_pipelined_equals_per_batch():
    enc = Polar5GEncoder(64, 128, device="cpu")
    dec = Polar5GDecoder(enc, dec_type="hybSCL", list_size=8)
    batches = [torch.from_numpy(_5g_logits(enc, bs, seed=9 + bs)[1])
               for bs in (32, 48)]
    piped = dec.decode_pipelined(batches, scl_batch=64)
    dec.prewarm(16, scl_capacity=256)
    for llr, u_p in zip(batches, piped):
        assert torch.equal(u_p, dec(llr))


def test_hybrid_in_sim_ber():
    """``sim_ber`` drives the hybrid chain end to end (the JAX package's
    ``test_hybrid_in_sim_ber`` case)."""
    n, k = 64, 32
    frozen, _ = generate_5g_ranking(k, n)
    model = SystemAWGNModel(n, k, PolarEncoder(frozen, n, device="cpu"),
                            HybridSCLDecoder(frozen, n, list_size=8,
                                             crc_degree=DEG, min_capacity=4,
                                             device="cpu"))
    ber, bler = sim_ber(model, [2.0, 4.0], batch_size=64, max_mc_iter=2,
                        verbose=False)
    assert ber.shape == (2,)
    assert 0.0 <= ber[0] <= 1.0 and ber[1] <= ber[0] + 0.05
