"""polar_torch front-end ops against polar_tpu on the same NumPy inputs:
f/g updates, the polar transform, Eb/N0, mapping and demapping, the
channel and the error counters."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.ops import fg as jfg
from polar_tpu.ops.butterfly import polar_transform as j_polar_transform
from polar_tpu.ops.ebno import ebnodb2no as j_ebnodb2no
from polar_tpu.ops.mapping import (Constellation as JConstellation,
                                   Demapper as JDemapper, Mapper as JMapper)
from polar_tpu.sim import (count_block_errors as j_count_block_errors,
                           count_errors as j_count_errors)

from polar_torch.ops import fg as tfg
from polar_torch.ops.butterfly import polar_transform
from polar_torch.ops.channels import AWGN, complex_normal
from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.mapping import Constellation, Demapper, Mapper
from polar_torch.ops.source import binary_source
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.sim import count_block_errors, count_errors

from _torch_parity import run_both, ulp_diff


def _llr_pair(seed, size=20_000):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 12, size).astype(np.float32)
    y = rng.normal(0, 12, size).astype(np.float32)
    x[:50] = 0.0
    y[25:75] = -0.0
    return x, y


@pytest.mark.parametrize("llr_max", [30.0, 5.0])
def test_f_minsum_and_g_bit_equal(llr_max):
    x, y = _llr_pair(1)
    u = np.random.default_rng(2).integers(0, 2, x.shape).astype(np.int8)
    j, t = run_both(lambda a, b: jfg.f_minsum(a, b, llr_max),
                    lambda a, b: tfg.f_minsum(a, b, llr_max), x, y)
    np.testing.assert_array_equal(j, t)
    j, t = run_both(jfg.g, tfg.g, x, y, u)
    np.testing.assert_array_equal(j, t)


def test_f_exact_close():
    x, y = _llr_pair(3)
    j, t = run_both(jfg.f_exact, tfg.f_exact, x, y)
    # a difference of two softplus terms: each within a few ulp of 30
    np.testing.assert_allclose(j, t, rtol=1e-5, atol=1e-5)


def test_softplus_within_2_ulp():
    x = np.random.default_rng(4).uniform(-30, 30, 100_000).astype(np.float32)
    j = np.asarray(jnp.logaddexp(0.0, jnp.asarray(x)))
    t = tfg.softplus(torch.from_numpy(x)).numpy()
    assert ulp_diff(j, t).max() <= 2


def test_pm_update_close():
    x, _ = _llr_pair(5)
    rng = np.random.default_rng(6)
    pm = rng.exponential(3, x.shape).astype(np.float32)
    u = rng.integers(0, 2, x.shape).astype(np.int8)
    j, t = run_both(jfg.pm_update, tfg.pm_update, pm, x, u)
    assert ulp_diff(j, t).max() <= 2


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_polar_transform_equals_jax(axis, dtype):
    shape = [16, 8, 32]
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2, shape).astype(dtype)
    j, t = run_both(lambda a: j_polar_transform(a, axis=axis),
                    lambda a: polar_transform(a, axis=axis), x)
    assert t.dtype == dtype
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(
        polar_transform(torch.from_numpy(t), axis=axis).numpy(), x)


@pytest.mark.parametrize("ebno_db", [-2.0, 0.0, 1.5, 3.0])
def test_ebnodb2no_equals_jax(ebno_db):
    j = np.asarray(j_ebnodb2no(ebno_db, 2, 512 / 1024))
    t = ebnodb2no(ebno_db, 2, 512 / 1024).numpy()
    np.testing.assert_array_equal(j, t)


def test_binary_source_statistics():
    gen = torch.Generator().manual_seed(0)
    bits = binary_source(gen, (400, 500))
    assert bits.dtype == torch.float32 and bits.shape == (400, 500)
    assert set(bits.unique().tolist()) == {0.0, 1.0}
    assert abs(bits.mean().item() - 0.5) < 0.005


@pytest.mark.parametrize("m", [2, 4])
def test_mapping_equals_jax_and_fixture(mapping_fix, m):
    c = Constellation(m, device="cpu")
    np.testing.assert_array_equal(c.points.numpy(),
                                  np.asarray(JConstellation(m).points))
    bits = mapping_fix[f"qam{m}_bits"]
    x_t = Mapper(c)(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(
        x_t, np.asarray(JMapper(JConstellation(m))(jnp.asarray(bits))))
    np.testing.assert_allclose(x_t, mapping_fix[f"qam{m}_x"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_demapper_equals_jax_and_fixture(mapping_fix, m):
    y = mapping_fix[f"qam{m}_y"]
    no = float(mapping_fix[f"qam{m}_no"])
    t = Demapper(Constellation(m, device="cpu"))(
        (torch.from_numpy(y), no)).numpy()
    j = np.asarray(JDemapper(JConstellation(m))((jnp.asarray(y), no)))
    if m == 2:       # closed form: the same f32 operations on both sides
        np.testing.assert_array_equal(t, j)
    else:            # logsumexp over the points: summation order differs
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t, mapping_fix[f"qam{m}_llr"], rtol=1e-4,
                               atol=1e-4)


def test_demapper_closed_form_equals_logsumexp():
    rng = np.random.default_rng(8)
    y = (rng.normal(size=(64, 32)) + 1j * rng.normal(size=(64, 32))).astype(
        np.complex64)
    c = Constellation(2, device="cpu")
    closed = Demapper(c)((torch.from_numpy(y), 0.7))
    general = Demapper(c)._logits2llrs(
        -(torch.from_numpy(y)[..., None] - c.points).abs() ** 2
        / torch.tensor(0.7)).reshape(64, 64)
    np.testing.assert_allclose(closed.numpy(), general.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_complex_normal_statistics():
    x = complex_normal(torch.Generator().manual_seed(0), (200_000,), var=2.0)
    assert x.dtype == torch.complex64
    assert abs((x.abs() ** 2).mean().item() - 2.0) < 0.05
    assert abs(x.real.mean().item()) < 0.02


def test_awgn_noise_power():
    x = torch.ones(100_000, dtype=torch.complex64)
    y = AWGN()(torch.Generator().manual_seed(1), (x, 0.5))
    assert abs(((y - x).abs() ** 2).mean().item() - 0.5) < 0.02


class _Uncoded:
    """Identity encoder (k = n) for the uncoded link."""
    device = torch.device("cpu")

    def __call__(self, bits):
        return bits


def test_uncoded_qpsk_ber_matches_theory():
    # uncoded QPSK over AWGN: BER = Q(sqrt(2 Eb/N0))
    from scipy.stats import norm
    n, ebno_db = 128, 4.0
    model = SystemAWGNModel(n, n, _Uncoded(), lambda llr: (llr > 0).float())
    gen = torch.Generator().manual_seed(2)
    errs = sum(count_errors(*model.step(gen, 2000, ebno_db)).item()
               for _ in range(10))
    ber = errs / (10 * 2000 * n)
    want = norm.sf(np.sqrt(2 * 10 ** (ebno_db / 10)))
    assert abs(ber - want) / want < 0.15


def test_error_counters_equal_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2, (64, 32)).astype(np.float32)
    b = a.copy()
    b[rng.random(a.shape) < 0.01] += 1.0
    for jfn, tfn in ((j_count_errors, count_errors),
                     (j_count_block_errors, count_block_errors)):
        j, t = run_both(jfn, tfn, a, b)
        assert int(j) == int(t)
