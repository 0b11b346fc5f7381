"""The polar_torch two-level fast-SCL sweep against JAX's
``scl_sweep_hybrid_fast`` on the same LLRs: the 5G chain with rate-1 nodes,
the kernel's per-codeword routine inside the sweep, and upper nodes
(repetition, rate-1, SPC) that span whole subtrees."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar import scan_core as jsc

from polar_torch.models.polar import scan_core as tsc
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_scl import scl_subtree_host

from _torch_parity import assert_blocks_agree


def _mask_5g(k, n):
    mask = np.zeros(n, bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


def _llr_ch(n, bs, seed):
    """Channel LLRs (positive means bit 0) of random codewords of BPSK
    over AWGN at about 2 dB."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (n, bs))
    y = (1.0 - 2.0 * c) + rng.normal(0, 0.8, (n, bs))
    return (2.0 * y / 0.64).astype(np.float32)


def _sweeps(mask, L, b, mode, rate1, bs, seed, spc=None, subtree=None):
    """JAX's and the port's sweep on the same LLRs: ``((u, pm), (u, pm))``
    as NumPy arrays."""
    llr = _llr_ch(len(mask), bs, seed)
    u_j, pm_j = jsc.scl_sweep_hybrid_fast(
        jnp.asarray(llr), mask, L, mode=mode, lower_stages=b,
        use_pallas=False, rate1=rate1)
    kw = {} if subtree is None else {"subtree": subtree}
    u_t, pm_t = tsc.scl_sweep_hybrid_fast(
        torch.from_numpy(llr), mask, L, mode=mode, lower_stages=b,
        rate1=rate1, spc_min_stage=spc, **kw)
    assert u_t.dtype == torch.int8 and u_t.shape == (len(mask), L, bs)
    return ((np.asarray(u_j), np.asarray(pm_j)),
            (u_t.numpy(), pm_t.numpy()))


@pytest.mark.parametrize("b", [4, 8])
def test_sweep_equals_jax_5g_n256_rate1(b):
    (u_j, pm_j), (u_t, pm_t) = _sweeps(_mask_5g(128, 256), 8, b, "minsum",
                                       True, bs=256, seed=b)
    assert_blocks_agree((u_j,), (u_t,), pm_j, pm_t)


def test_sweep_with_host_kernel_routine_equals_jax():
    """The kernel's per-codeword routine (host build) inside the sweep,
    as a split tree and as the whole tree (broadcast channel input)."""
    mask = _mask_5g(128, 256)
    for b in (5, 8):
        (u_j, pm_j), (u_t, pm_t) = _sweeps(mask, 8, b, "minsum", True,
                                           bs=128, seed=10 + b,
                                           subtree=scl_subtree_host)
        assert_blocks_agree((u_j,), (u_t,), pm_j, pm_t)


def _upper_rep_mask():
    mask = np.zeros(64, bool)
    mask[:31] = True         # repetition node at stage 5: 4 subtrees at b=3
    mask[40] = True
    return mask


def _upper_rate1_mask():
    mask = np.zeros(64, bool)
    mask[:8] = True          # rate-1 nodes at stages 3, 4 and 5
    return mask


@pytest.mark.parametrize("case", ["upper_rep", "upper_rate1", "all_info",
                                  "5g_k100_exact"])
def test_sweep_upper_nodes_equal_jax(case):
    mask, L, mode = {
        "upper_rep": (_upper_rep_mask(), 8, "minsum"),
        "upper_rate1": (_upper_rate1_mask(), 8, "minsum"),
        "all_info": (np.zeros(64, bool), 4, "minsum"),
        "5g_k100_exact": (_mask_5g(100, 256), 8, "exact"),
    }[case]
    (u_j, pm_j), (u_t, pm_t) = _sweeps(mask, L, 3, mode, True, bs=64,
                                       seed=len(case))
    assert_blocks_agree((u_j,), (u_t,), pm_j, pm_t)


def test_sweep_spc_nodes_equal_jax(monkeypatch):
    # the JAX side reads its SPC threshold from the environment
    monkeypatch.setenv("POLAR_TPU_SPC_MIN_STAGE", "2")
    rng = np.random.default_rng(21)
    mask = np.zeros(64, bool)
    mask[[0, 16, 32, 33, 34, 48]] = True     # SPC spans of stages 4 and 3
    mask[rng.integers(0, 64, 6)] = True
    assert any(u[0] == "s" for u in jsc.split_fast_schedule(mask, 3,
                                                            rate1=True)[0])
    (u_j, pm_j), (u_t, pm_t) = _sweeps(mask, 8, 3, "minsum", True, bs=64,
                                       seed=3, spc=2)
    assert_blocks_agree((u_j,), (u_t,), pm_j, pm_t)
