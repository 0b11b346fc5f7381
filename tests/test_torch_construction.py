"""polar_torch construction, encoder and fast-SCL schedules against
polar_tpu and the reference fixtures."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar import scan_core as jsc
from polar_tpu.models.polar.construction import (
    generate_5g_ranking as j_generate_5g_ranking)
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder

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
    c = PolarEncoder(frozen, n, device="cpu")(torch.from_numpy(u))
    assert c.dtype == torch.float32 and c.shape == (16, n)
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(JPolarEncoder(frozen, n)(jnp.asarray(u))))


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
