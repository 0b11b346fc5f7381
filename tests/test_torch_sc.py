"""The polar_torch SC decoder and its subtree kernel against polar_tpu: the
golden fixtures, JAX's decoder on random blocks, the Pallas SC kernel
(interpret mode) against the plain version, the host build of the CUDA
kernel's routine against the plain version, and the two-level sweep at
every depth against the whole tree. The kernel itself is tested on the
card in ``test_torch_gpu.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.pallas_scl import sc_subtree_pallas
from polar_tpu.models.polar.sc import PolarSCDecoder as JPolarSCDecoder

from _torch_parity import run_both
from polar_torch import from_numpy_state
from polar_torch.models.polar.construction import (generate_5g_ranking,
                                                   get_kern_frozen_bits)
from polar_torch.models.polar.cuda_sc import (
    DEFAULT_LANES, SC_KIND_CODES, SMEM_BUDGET, block_smem_bytes, sc_schedule,
    sc_subtree, sc_subtree_host, sc_subtree_plain, shared_stages,
    traced_schedule)
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scan_core import fast_schedule, sc_sweep_hybrid
from polar_torch.ops.butterfly import polar_transform

LLR_MAX = 30.0
# share of blocks on which the host build must equal the plain version in
# exact mode (the exact boxplus rounds differently in log1pf/expf and
# torch.logaddexp)
EXACT_AGREEMENT = 0.995


def _mask_5g(k, n):
    mask = np.zeros(n, bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


def _random_mask(n, rng):
    return rng.random(n) < rng.uniform(0.2, 0.8)


def _constructed_mask(n, rng):
    """Random rate; frozen by row weight with random order among equal
    weights, so info leaves sit at reliable positions as in a real code."""
    _, weights, _ = get_kern_frozen_bits(n, 0)
    order = np.lexsort((rng.random(n), weights))
    mask = np.zeros(n, bool)
    mask[order[:int(rng.uniform(0.2, 0.8) * n)]] = True
    return mask


def _codeword_llr(mask, bs, sigma, rng):
    """Channel LLRs (positive means bit 0) of random codewords of ``mask``,
    BPSK over AWGN with noise deviation ``sigma``."""
    u = rng.integers(0, 2, (len(mask), bs)) * (~mask)[:, None]
    c = polar_transform(torch.from_numpy(u.astype(np.int8)), axis=0).numpy()
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _logits(n, bs, seed):
    return -_codeword_llr(np.zeros(n, bool), bs, 0.8,
                          np.random.default_rng(seed)).T


@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("n", [64, 256])
def test_decoder_equals_golden_fixture_and_jax(decoders_fix, n, mode):
    frozen = decoders_fix[f"n{n}_frozen_pos"]
    llr = decoders_fix[f"n{n}_llr"]
    want = decoders_fix[f"n{n}_sc_{mode}"]
    jax_out = np.asarray(JPolarSCDecoder(frozen, n, mode=mode)(
        jnp.asarray(llr)))
    np.testing.assert_array_equal(jax_out, want)
    for b in (None, 3):
        got = PolarSCDecoder(frozen, n, mode=mode, lower_stages=b,
                             device="cpu")(torch.from_numpy(llr))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_minsum_random_blocks_equal_jax():
    n, k = 256, 128
    frozen, _ = generate_5g_ranking(k, n)
    want, got = run_both(JPolarSCDecoder(frozen, n),
                         PolarSCDecoder(frozen, n, device="cpu"),
                         _logits(n, 256, 11))
    np.testing.assert_array_equal(got, want)


def test_from_numpy_state_builds_sc_decoder():
    n, k = 128, 64
    frozen, _ = generate_5g_ranking(k, n)
    state = dict(frozen_pos=frozen, n=n, k=k, mode="minsum", llr_max=30.0,
                 decoder="sc")
    model = from_numpy_state(state, device="cpu")
    assert isinstance(model.decoder, PolarSCDecoder) and model.k == k
    want, got = run_both(JPolarSCDecoder(frozen, n), model.decoder,
                         _logits(n, 64, 12))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown decoder"):
        from_numpy_state(dict(state, decoder="ml"), device="cpu")


@pytest.mark.parametrize("form", ["static", "traced"])
@pytest.mark.parametrize("b", [4, 6])
def test_plain_subtree_equals_pallas_interpret(b, form):
    rng = np.random.default_rng(b)
    mask = _random_mask(1 << b, rng)
    a = rng.normal(0, 3, (1 << b, 128)).astype(np.float32)
    frz = mask.astype(np.int32)
    if form == "static":
        ops = tuple(fast_schedule(mask, rep=False))
        assert any(op[0] == "z" for op in ops)
        want = sc_subtree_pallas(jnp.asarray(a), None, b=b, llr_max=LLR_MAX,
                                 mode="minsum", interpret=True,
                                 sched_static=ops)
    else:
        ops = traced_schedule(b)
        want = sc_subtree_pallas(jnp.asarray(a), jnp.asarray(frz), b=b,
                                 llr_max=LLR_MAX, mode="minsum",
                                 interpret=True)
    got = sc_subtree_plain(torch.from_numpy(a), torch.from_numpy(frz), ops,
                           b=b, llr_max=LLR_MAX, mode="minsum")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lanes", [None, 32])
@pytest.mark.parametrize("form", ["static", "traced"])
@pytest.mark.parametrize("mode", ["minsum", "exact"])
def test_host_build_equals_plain(mode, form, lanes):
    """Min-sum on uniformly random masks and N(0, 3^2) LLRs: bit-equal.
    Exact mode on constructed masks and codeword LLRs: the exact boxplus
    loses all precision below ~1e-7 in f32, so an info leaf at an
    unreliable position would be decided by rounding in either version.
    The card's group size and split, or 32 lanes (segments narrower than
    the group from stage 5 down) with the upper half of the workspace
    stages in the global scratch."""
    rng = np.random.default_rng(7 if mode == "minsum" else 8)
    blocks = differ = 0
    for b in range(1, 9):
        for _ in range(3):
            if mode == "minsum":
                mask = _random_mask(1 << b, rng)
                a = rng.normal(0, 3, (1 << b, 128)).astype(np.float32)
            else:
                mask = _constructed_mask(1 << b, rng)
                a = _codeword_llr(mask, 128, 0.8, rng)
            ops = (fast_schedule(mask, rep=False) if form == "static"
                   else traced_schedule(b))
            a_t = torch.from_numpy(a)
            frz = torch.from_numpy(mask.astype(np.int32))
            kw = dict(b=b, llr_max=LLR_MAX, mode=mode)
            want = sc_subtree_plain(a_t, frz, ops, **kw).numpy()
            got = sc_subtree_host(
                a_t, frz, sc_schedule(ops, "cpu"), lanes=lanes,
                n_shared=None if lanes is None else b // 2, **kw).numpy()
            if mode == "minsum":
                np.testing.assert_array_equal(got, want)
            blocks += want.shape[1]
            differ += int((got != want).any(axis=0).sum())
    print(f"host build against plain, {mode} {form}: {differ} of {blocks} "
          "blocks differ")
    assert differ <= (1.0 - EXACT_AGREEMENT) * blocks


def test_group_size_and_shared_budget():
    """The host build lays out a block as the card does: the stages that
    fit SMEM_BUDGET go to shared memory, from stage 0 up."""
    assert DEFAULT_LANES == 8
    assert block_smem_bytes(8, 8, 8, "host") == 41008
    for b, lanes in ((8, 8), (9, 8), (10, 16), (10, 4)):
        n = shared_stages(b, lanes, "host")
        assert n == b or block_smem_bytes(b, lanes, n + 1, "host") > \
            SMEM_BUDGET
        assert n == 0 or block_smem_bytes(b, lanes, n, "host") <= \
            SMEM_BUDGET
    assert shared_stages(9, 8, "host") == 6
    with pytest.raises(ValueError):       # 32 codewords of b=10 tiles
        sc_subtree_host(torch.zeros(1024, 4), torch.zeros(
            1024, dtype=torch.int32), sc_schedule(traced_schedule(10), "cpu"),
            b=10, llr_max=LLR_MAX, mode="minsum", lanes=4, n_shared=10)
    with pytest.raises(ValueError):
        sc_subtree_host(torch.zeros(4, 4), torch.zeros(4, dtype=torch.int32),
                        sc_schedule(traced_schedule(2), "cpu"), b=2,
                        llr_max=LLR_MAX, mode="minsum", lanes=12)


@pytest.mark.parametrize("b", range(1, 9))
def test_two_level_sweep_equals_whole_tree(b):
    n = 256
    rng = np.random.default_rng(b)
    mask = _mask_5g(100, n) if b % 2 else _random_mask(n, rng)
    llr = torch.from_numpy(_codeword_llr(mask, 96, 0.9, rng))
    whole = sc_sweep_hybrid(llr, mask, lower_stages=8)
    got = sc_sweep_hybrid(llr, mask, lower_stages=b)
    assert got.dtype == torch.int8 and got.shape == (n, 96)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


def test_sweep_with_host_build_equals_plain():
    mask = _mask_5g(128, 256)
    rng = np.random.default_rng(3)
    llr = torch.from_numpy(_codeword_llr(mask, 64, 0.9, rng))

    def host(a, frz, sched, **kw):
        return sc_subtree_host(a.contiguous(), frz, sched, **kw)

    for b in (3, 8):
        np.testing.assert_array_equal(
            sc_sweep_hybrid(llr, mask, lower_stages=b, subtree=host).numpy(),
            sc_sweep_hybrid(llr, mask, lower_stages=b).numpy())


def test_zero_llr_decides_one_and_leading_dims():
    n, k = 64, 32
    frozen, _ = generate_5g_ranking(k, n)
    dec = PolarSCDecoder(frozen, n, device="cpu")
    zeros = torch.zeros(2, 3, n)
    got = dec(zeros)
    assert got.shape == (2, 3, k)
    # every leaf LLR is 0, so every info bit decides 1
    assert bool((got == 1).all())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JPolarSCDecoder(frozen, n)(
            jnp.zeros((2, 3, n)))))
    logits = torch.from_numpy(_logits(n, 6, 2))
    np.testing.assert_array_equal(dec(logits.reshape(2, 3, n)).numpy(),
                                  dec(logits).reshape(2, 3, k).numpy())


def test_decoder_options_and_errors():
    frozen, _ = generate_5g_ranking(32, 64)
    # PC-aided decoding: a frozen PC position raises, an info one leaves
    # the output and the decode runs the whole tree in one call
    with pytest.raises(ValueError, match="frozen"):
        PolarSCDecoder(frozen, 64, pc_pos=[3], device="cpu")
    pc_dec = PolarSCDecoder(frozen, 64, pc_pos=[63], device="cpu")
    assert pc_dec.k == 31 and pc_dec.lower_stages == 6
    assert pc_dec(torch.zeros(4, 64)).shape == (4, 31)
    with pytest.raises(ValueError):
        PolarSCDecoder(frozen, 64, mode="bad", device="cpu")
    with pytest.raises(ValueError):
        PolarSCDecoder(frozen, 64, schedule="bad", device="cpu")
    dec = PolarSCDecoder(frozen, 64, schedule="unrolled",
                         output_dtype=torch.int8, device="cpu")
    assert dec.lower_stages == 6           # the default, clamped to log2(n)
    assert dec(torch.zeros(4, 64)).dtype == torch.int8
    with pytest.raises(ValueError):
        dec(torch.zeros(4, 32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PolarSCDecoder(frozen, 64)


def test_wrapper_runs_plain_version_on_cpu():
    mask = _mask_5g(16, 32)
    ops = fast_schedule(mask, rep=False)
    a = torch.from_numpy(np.random.default_rng(1).normal(
        0, 3, (32, 16)).astype(np.float32))
    before = sc_subtree.launches
    got = sc_subtree(a, None, sc_schedule(ops, "cpu"), b=5,
                     llr_max=LLR_MAX, mode="minsum")
    assert sc_subtree.launches == before
    np.testing.assert_array_equal(
        got.numpy(), sc_subtree_plain(a, None, ops, b=5, llr_max=LLR_MAX,
                                      mode="minsum").numpy())


def test_schedule_encoding_and_bad_inputs():
    ops = (("z", 2, 0), ("f", 0, 4), ("i", 0, 5), ("t", 0, 6), ("t", 0, 7))
    sched = sc_schedule(ops, "cpu")
    assert sched.table[:, 0].tolist() == [SC_KIND_CODES[k] for k, _, _ in ops]
    assert sched.span == 8
    with pytest.raises(ValueError):       # a repetition node is not SC's
        sc_schedule((("r", 1, 0),), "cpu")
    traced = sc_schedule(traced_schedule(2), "cpu")
    a = torch.zeros(4, 8)
    frz = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):       # 't' ops and no frz
        sc_subtree_host(a, None, traced, b=2, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # 8 rows are not 2^2
        sc_subtree_host(torch.zeros(8, 8), frz, traced, b=2,
                        llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(ValueError):       # schedule of 4 leaves at b=3
        sc_subtree_host(torch.zeros(8, 8), torch.zeros(8, dtype=torch.int32),
                        traced, b=3, llr_max=LLR_MAX, mode="minsum")
    with pytest.raises(TypeError):
        sc_subtree_host(a.double(), frz, traced, b=2, llr_max=LLR_MAX,
                        mode="minsum")
