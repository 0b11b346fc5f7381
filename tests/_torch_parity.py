"""Shared helpers of the polar_torch tests: the same NumPy inputs go through
a polar_tpu function on JAX-CPU and its polar_torch counterpart on the CPU,
and the outputs come back as NumPy arrays. JAX is imported only where a
helper calls it, so the card's tests can use the rest without it."""

import numpy as np
import torch

# decisions (codewords, parent maps) must agree on at least this share of
# blocks; path metrics then agree to PM_RTOL on the agreeing blocks
BLOCK_AGREEMENT = 0.998
PM_RTOL = 1e-5


def run_both(jax_fn, torch_fn, *inputs):
    """``(jax_out, torch_out)`` of the two functions on the same NumPy
    inputs; tuple outputs come back as tuples of arrays."""
    def to_np(out):
        if isinstance(out, (tuple, list)):
            return tuple(to_np(o) for o in out)
        if isinstance(out, torch.Tensor):
            return out.detach().cpu().numpy()
        return np.asarray(out)

    import jax.numpy as jnp
    j = jax_fn(*[jnp.asarray(x) for x in inputs])
    t = torch_fn(*[torch.from_numpy(np.ascontiguousarray(x))
                   for x in inputs])
    return to_np(j), to_np(t)


def ulp_diff(a, b):
    """Elementwise distance in units of the last place of two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2 ** 31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 31) - ib, ib)
    return np.abs(ia - ib)


def block_agreement(dec_a, dec_b, pm_a, pm_b):
    """Share of blocks (the last axis of every decision array) whose
    decisions all agree, the largest relative path-metric gap on those
    blocks, and the mask of differing blocks. ``dec_a``/``dec_b`` are
    sequences of arrays."""
    bad = None
    for x, y in zip(dec_a, dec_b):
        x, y = np.asarray(x), np.asarray(y)
        diff = (x != y).reshape(-1, x.shape[-1]).any(axis=0)
        bad = diff if bad is None else bad | diff
    pm_a = np.asarray(pm_a, np.float64)[..., ~bad]
    pm_b = np.asarray(pm_b, np.float64)[..., ~bad]
    rel = np.abs(pm_a - pm_b) / np.maximum(np.abs(pm_a), 1e-6)
    return 1.0 - bad.mean(), (float(rel.max()) if rel.size else 0.0), bad


def assert_blocks_agree(dec_a, dec_b, pm_a, pm_b):
    share, rel, bad = block_agreement(dec_a, dec_b, pm_a, pm_b)
    assert share >= BLOCK_AGREEMENT, (
        f"decisions agree on {share:.4f} of blocks (< {BLOCK_AGREEMENT}); "
        f"differing blocks {np.flatnonzero(bad).tolist()}")
    assert rel <= PM_RTOL, f"path metrics differ by {rel:.3g} relative"
    return share, bad



# OSD: a block may differ from the reference only where the two codewords'
# float64 distances agree to this relative gap (both found an equally good
# codeword; torch's and JAX's softplus differ by an ulp on some inputs)
OSD_TIE_RTOL = 1e-6


def osd_distance(llr, c, llr_max):
    """Float64 OSD distance, mean softplus(llr * (1 - 2c)), of codewords
    ``c [..., n]`` for the clipped LLRs ``llr [..., n]``."""
    llr = np.clip(np.asarray(llr, np.float64), -llr_max, llr_max)
    sgn = llr * (1.0 - 2.0 * np.asarray(c, np.float64))
    return np.mean(np.logaddexp(0.0, sgn), axis=-1)


def assert_osd_agrees(llr, got, want, llr_max):
    """Codewords ``got`` and ``want`` agree on every block, but where their
    float64 distances tie to ``OSD_TIE_RTOL``. Returns the differing
    blocks' count."""
    bad = (np.asarray(got) != np.asarray(want)).any(axis=-1)
    d_got = osd_distance(llr, got, llr_max)[bad]
    d_want = osd_distance(llr, want, llr_max)[bad]
    gap = np.abs(d_got - d_want) / np.maximum(np.abs(d_want), 1e-12)
    assert np.all(gap <= OSD_TIE_RTOL), (
        f"blocks {np.flatnonzero(bad).tolist()} differ with distance gaps "
        f"{gap.tolist()}")
    return int(bad.sum())
