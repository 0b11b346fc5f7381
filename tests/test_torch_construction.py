"""polar_torch construction, encoder and fast-SCL schedules against
polar_tpu and the reference fixtures."""

import filecmp
import os

import numpy as np
import pytest
import torch

from polar_tpu import native as jnative
from polar_tpu.models.polar import construction as jconstruction
from polar_tpu.models.polar import scan_core as jsc
from polar_tpu.models.polar.construction import (
    generate_5g_ranking as j_generate_5g_ranking)
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder

from _torch_parity import run_both
from polar_torch.models.polar import construction as tconstruction
from polar_torch.models.polar import ga as tga
from polar_torch.models.polar import scan_core as tsc
from polar_torch.models.polar.construction import (generate_5g_ranking,
                                                   info_positions)
from polar_torch.models.polar.encode import PolarEncoder


@pytest.mark.parametrize("k,n", [(32, 64), (12, 32), (100, 256),
                                 (512, 1024), (37, 128)])
def test_5g_ranking_equals_jax_and_fixture(construction_fix, k, n):
    frozen, info = generate_5g_ranking(k, n)
    np.testing.assert_array_equal(frozen,
                                  construction_fix[f"rank_k{k}_n{n}_frozen"])
    np.testing.assert_array_equal(info,
                                  construction_fix[f"rank_k{k}_n{n}_info"])
    for sort in (True, False):
        for a, b in zip(generate_5g_ranking(k, n, sort=sort),
                        j_generate_5g_ranking(k, n, sort=sort)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(info_positions(frozen, n), info)


@pytest.mark.parametrize("k,n", [(10, 2048), (65, 64), (8, 16)])
def test_5g_ranking_rejects_invalid_codes(k, n):
    with pytest.raises(ValueError):
        generate_5g_ranking(k, n)


@pytest.mark.parametrize("k,n", [(32, 64), (100, 256), (512, 1024)])
def test_encoder_equals_jax(k, n):
    frozen, _ = generate_5g_ranking(k, n)
    u = np.random.default_rng(n).integers(0, 2, (16, k)).astype(np.float32)
    want, c = run_both(JPolarEncoder(frozen, n),
                       PolarEncoder(frozen, n, device="cpu"), u)
    assert c.dtype == np.float32 and c.shape == (16, n)
    np.testing.assert_array_equal(c, want)


def _random_masks(n, count, seed):
    rng = np.random.default_rng(seed)
    masks = []
    for _ in range(count):
        mask = rng.random(n) < rng.uniform(0.1, 0.9)
        masks.append(mask)
    masks.append(np.zeros(n, bool))
    masks.append(np.ones(n, bool))
    return masks


@pytest.mark.parametrize("rate1", [False, True])
@pytest.mark.parametrize("spc", [None, 1, 2, 4])
def test_fast_schedule_equals_jax(rate1, spc):
    for n in (16, 64, 256):
        for mask in _random_masks(n, 8, n + (spc or 0)):
            for rep in (True, False):
                assert (tsc.fast_schedule(mask, rep=rep, rate1=rate1,
                                          spc_min_stage=spc)
                        == jsc.fast_schedule(
                            mask, rep=rep, rate1=rate1,
                            spc_min_stage=jsc.SPC_MIN_STAGE_OFF
                            if spc is None else spc))


def test_spc_threshold_clamps_to_stage_1():
    """A threshold of 0 would turn a frozen leaf into an SPC node of one
    position; the port clamps it to stage 1."""
    mask = np.array([1, 0, 0, 0, 1, 1, 0, 1], bool)
    ops0 = tsc.fast_schedule(mask, rate1=True, spc_min_stage=0)
    assert ops0 == tsc.fast_schedule(mask, rate1=True, spc_min_stage=1)
    assert not any(k == "s" and s == 0 for k, s, _ in ops0)


@pytest.mark.parametrize("rate1", [False, True])
def test_split_fast_schedule_equals_jax(rate1):
    for n in (32, 256, 1024):
        S = n.bit_length() - 1
        masks = _random_masks(n, 4, n)
        frozen, _ = generate_5g_ranking(n // 2, n)
        mask5g = np.zeros(n, bool)
        mask5g[frozen] = True
        for mask in masks + [mask5g]:
            for b in range(1, S + 1):
                assert (tsc.split_fast_schedule(mask, b, rate1=rate1)
                        == jsc.split_fast_schedule(mask, b, rate1=rate1))


def test_split_fast_schedule_spc_equals_jax(monkeypatch):
    # the JAX side reads its SPC threshold from the environment
    monkeypatch.setenv("POLAR_TPU_SPC_MIN_STAGE", "2")
    for mask in _random_masks(128, 6, 5):
        for b in (2, 4, 7):
            assert (tsc.split_fast_schedule(mask, b, rate1=True,
                                            spc_min_stage=2)
                    == jsc.split_fast_schedule(mask, b, rate1=True))


def test_ref_rm_orders_copy_and_frozen_sets_equal_jax():
    """The port's copy of ``ref_rm_orders.npz`` is byte-equal to the JAX
    package's, and gives the same frozen set for every captured key."""
    here = os.path.dirname(tconstruction.__file__)
    there = os.path.dirname(jconstruction.__file__)
    assert filecmp.cmp(os.path.join(here, "ref_rm_orders.npz"),
                       os.path.join(there, "ref_rm_orders.npz"),
                       shallow=False)
    with np.load(os.path.join(here, "ref_rm_orders.npz")) as z:
        keys = list(z.keys())
    kernels = {key.rsplit("_n", 1)[0] for key in keys}
    assert len(keys) == 64 and len(kernels) == 19
    for key in keys:
        name, n = key.rsplit("_n", 1)
        n = int(n)
        for f_num in (0, 1, n // 4, n // 2, n - 1, n):
            np.testing.assert_array_equal(
                tconstruction.get_ref_rm_frozen_bits(n, f_num, name),
                jconstruction.get_ref_rm_frozen_bits(n, f_num, name),
                err_msg=key)
    with pytest.raises(ValueError, match="no captured reference order"):
        tconstruction.get_ref_rm_frozen_bits(48, 8)
    with pytest.raises(ValueError):
        tconstruction.get_ref_rm_frozen_bits(64, 65)


def test_rm_code_equals_jax():
    for m in range(1, 11):
        for r in range(m + 1):
            for got, want in zip(tconstruction.generate_rm_code(r, m),
                                 jconstruction.generate_rm_code(r, m)):
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tconstruction.generate_rm_code(4, 3)


def test_ga_means_of_the_host_build_equal_the_twins():
    """The g++ build of ``csrc/ga_host.cpp`` against the port's NumPy twin
    (to 1e-6 relative below the saturation cap, where libm and NumPy may
    round apart) and that twin bit for bit against the JAX package's twin
    (``force_numpy``, so the JAX package's committed library is left as
    it is)."""
    for n, m0 in ((32, 1.0), (64, 3.2), (512, 1.0), (1024, 3.2)):
        built = tga.ga_bit_channel_means(n, m0)
        twin = tga.ga_bit_channel_means(n, m0, force_numpy=True)
        np.testing.assert_array_equal(
            twin, jnative.ga_bit_channel_means(n, m0, force_numpy=True))
        live = (built < 1e6) & (twin < 1e6)
        np.testing.assert_allclose(built[live], twin[live], rtol=1e-6)
    with pytest.raises(ValueError):
        tga.ga_bit_channel_means(12, 1.0)


@pytest.mark.parametrize("design_db", [0.0, 2.0])
def test_ga_frozen_sets_equal_jax(monkeypatch, design_db):
    monkeypatch.setattr(jnative, "ga_bit_channel_means",
                        lambda n, m0: jnative._ga_means_numpy(n, m0))
    for n in (32, 64, 128, 256, 512, 1024):
        for k in (n // 4, 3 * n // 4):
            for got, want in zip(
                    tconstruction.generate_ga_code(k, n, design_db),
                    jconstruction.generate_ga_code(k, n, design_db)):
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tconstruction.generate_ga_code(64, 64)
