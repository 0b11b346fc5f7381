"""The polar_torch SCL decoder (fast and plain sweeps) and chain against
polar_tpu: the golden decoder fixtures bit for bit, JAX's plain sweep on
random blocks, the decoder's options and their defaults, the state carried
across, and the package's independence from JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.construction import (
    generate_5g_ranking as j_generate_5g_ranking)
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder
from polar_tpu.models.polar import scan_core as jsc
from polar_tpu.models.polar.scl import PolarSCLDecoder as JPolarSCLDecoder

from polar_torch import PolarEncoder, from_numpy_state
from polar_torch.models.polar import scan_core as tsc
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_scl import scl_subtree_host
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.ops.crc import CRCEncoder
from polar_torch.sim import count_block_errors

from _torch_parity import assert_blocks_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("b", [None, 3])
@pytest.mark.parametrize("list_size", [4, 8])
@pytest.mark.parametrize("n", [64, 256])
def test_decoder_equals_golden_fixture(decoders_fix, n, list_size, b):
    frozen = decoders_fix[f"n{n}_frozen_pos"]
    llr = decoders_fix[f"n{n}_llr"]
    dec = PolarSCLDecoder(frozen, n, list_size=list_size, mode="exact",
                          use_fast_scl=True, lower_stages=b, device="cpu")
    got = dec(torch.from_numpy(llr)).numpy()
    np.testing.assert_array_equal(
        got, decoders_fix[f"n{n}_scl{list_size}_exact"])


@pytest.mark.parametrize("b", [None, 3])
@pytest.mark.parametrize("mode,key", [("minsum", "scl4_minsum"),
                                      ("exact", "scl4_exact_nofast")])
@pytest.mark.parametrize("n", [64, 256])
def test_plain_decoder_equals_golden_fixture_and_jax(decoders_fix, n, mode,
                                                     key, b):
    frozen = decoders_fix[f"n{n}_frozen_pos"]
    llr = decoders_fix[f"n{n}_llr"]
    want = decoders_fix[f"n{n}_{key}"]
    if b is None:
        j_dec = JPolarSCLDecoder(frozen, n, list_size=4, mode=mode,
                                 use_fast_scl=False)
        np.testing.assert_array_equal(np.asarray(j_dec(jnp.asarray(llr))),
                                      want)
    dec = PolarSCLDecoder(frozen, n, list_size=4, mode=mode,
                          use_fast_scl=False, lower_stages=b, device="cpu")
    assert not dec.use_fast_scl
    np.testing.assert_array_equal(dec(torch.from_numpy(llr)).numpy(), want)


@pytest.mark.parametrize("subtree", ["plain", "host"])
def test_plain_sweep_equals_jax_plain_sweep(subtree):
    """The port's plain sweep (the fast sweep on a leaf-only schedule)
    against JAX's ``scl_sweep_hybrid`` on random blocks, min-sum."""
    n, k, L, b = 256, 128, 8, 4
    frozen, _ = generate_5g_ranking(k, n)
    mask = np.zeros(n, bool)
    mask[frozen] = True
    llr = _llr_ch(n, 128, 21)
    u_j, pm_j = jsc.scl_sweep_hybrid(jnp.asarray(llr), mask, L,
                                     lower_stages=b, use_pallas=False)
    kw = {} if subtree == "plain" else {"subtree": scl_subtree_host}
    u_t, pm_t = tsc.scl_sweep_hybrid(torch.from_numpy(llr), mask, L,
                                     lower_stages=b, **kw)
    assert u_t.dtype == torch.int8 and u_t.shape == (n, L, 128)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=1e-5)


@pytest.mark.parametrize("n", [64, 1024])
def test_fast_sweep_default_equals_jax(n):
    frozen, _ = generate_5g_ranking(n // 2, n)
    want = JPolarSCLDecoder(frozen, n, list_size=8).use_fast_scl
    assert PolarSCLDecoder(frozen, n, device="cpu").use_fast_scl == want
    assert want == (n < 256)


def _llr_ch(n, bs, seed):
    """Channel LLRs (positive means bit 0) of random codewords of BPSK
    over AWGN at about 2 dB."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (n, bs))
    y = (1.0 - 2.0 * c) + rng.normal(0, 0.8, (n, bs))
    return (2.0 * y / 0.64).astype(np.float32)


def test_decoder_equals_jax_decoder_rate1():
    n, k = 128, 64
    frozen, _ = generate_5g_ranking(k, n)
    logits = -_llr_ch(n, 64, 7).T
    want = JPolarSCLDecoder(frozen, n, list_size=8, mode="minsum",
                            schedule="unrolled", use_fast_scl=True,
                            fast_rate1=True)(jnp.asarray(logits))
    got = PolarSCLDecoder(frozen, n, list_size=8, fast_rate1=True,
                          device="cpu")(torch.from_numpy(logits))
    assert got.shape == (64, k) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs,item", [
    ({"pc_pos": [3]}, "are frozen"),
    ({"pc_pos": [63], "fast_rate1": True}, "fast sweep"),
    ({"pc_pos": [63], "lower_stages": 3}, "whole tree"),
])
def test_decoder_raises_for_later_slices(kwargs, item):
    """PC-aided decoding, once left to a later slice, is ported; what it
    cannot take raises: a frozen PC position, the fast sweep's options,
    a subtree depth below log2(n)."""
    frozen, _ = generate_5g_ranking(32, 64)
    with pytest.raises(ValueError, match=item):
        PolarSCLDecoder(frozen, 64, device="cpu", **kwargs)
    dec = PolarSCLDecoder(frozen, 64, pc_pos=[63], device="cpu")
    assert dec.k == 31 and not dec.use_fast_scl


@pytest.mark.parametrize("kwargs", [
    {"crc_degree": "CRC11"}, {"crc_degree": "CRC11", "use_hybrid_sc": True},
    {"list_size": 16}, {"list_size": 32}])
def test_decoder_takes_the_options_of_the_5g_chain(kwargs):
    frozen, _ = generate_5g_ranking(32, 64)
    dec = PolarSCLDecoder(frozen, 64, device="cpu", **kwargs)
    out = dec(torch.zeros(3, 64))
    assert out.shape == (3, 32) and not out.any()


def test_decoder_raises_for_traced_frozen_set_and_bad_options():
    """A frozen set given as a tensor is copied to the host, as the JAX
    package's ``np.asarray`` does; options the port refuses raise."""
    frozen, _ = generate_5g_ranking(32, 64)
    logits = torch.from_numpy(-_llr_ch(64, 16, 3).T.copy())
    from_tensor = PolarSCLDecoder(torch.from_numpy(frozen), 64, device="cpu")
    np.testing.assert_array_equal(from_tensor.frozen_pos, frozen)
    assert torch.equal(from_tensor(logits),
                       PolarSCLDecoder(frozen, 64, device="cpu")(logits))
    with pytest.raises(ValueError):   # the reference drops this silently
        PolarSCLDecoder(frozen, 64, use_fast_scl=False, fast_rate1=True,
                        device="cpu")
    with pytest.raises(ValueError):   # n >= 256 defaults to the plain sweep
        PolarSCLDecoder(np.arange(128), 256, fast_rate1=True, device="cpu")
    with pytest.raises(ValueError):
        PolarSCLDecoder(frozen, 64, list_size=3, device="cpu")
    with pytest.raises(ValueError):   # the CRC status needs a CRC
        PolarSCLDecoder(frozen, 64, return_crc_status=True, device="cpu")


@pytest.mark.parametrize("n", [64, 256])
def test_ca_scl_equals_golden_fixture(decoders_fix, n):
    frozen = decoders_fix[f"n{n}_frozen_pos"]
    dec = PolarSCLDecoder(frozen, n, list_size=8, mode="exact",
                          crc_degree="CRC11", device="cpu")
    got = dec(torch.from_numpy(decoders_fix[f"n{n}_llr"]))
    np.testing.assert_array_equal(got.numpy(),
                                  decoders_fix[f"n{n}_scl8_crc11"])


def _crc_logits(n, k, bs, seed):
    """Logits of codewords whose info words carry a valid CRC11, at about
    1.5 dB: CA-SCL then has CRC-valid and CRC-failed paths to choose
    between."""
    frozen, _ = generate_5g_ranking(k, n)
    rng = np.random.default_rng(seed)
    enc = CRCEncoder("CRC11", k=k - 11)
    u = enc(torch.from_numpy(rng.integers(0, 2, (bs, k - 11)).astype(
        np.float32)))
    c = PolarEncoder(frozen, n, device="cpu")(u).numpy()
    sigma = np.sqrt(1.0 / (2 * 10 ** 0.15 * (k / n)))
    y = (2.0 * c - 1.0) + rng.normal(0, sigma, c.shape)
    return frozen, ((2.0 / sigma ** 2) * y).astype(np.float32)


@pytest.mark.parametrize("n,L,fast", [(64, 8, None), (64, 16, None),
                                      (64, 32, None), (256, 32, False)])
def test_ca_scl_equals_jax(n, L, fast):
    """CA-SCL at L = 8, 16, 32, fast and plain sweeps, on shared logits:
    decisions and CRC status equal JAX's on every block (a flip would be
    allowed only at a path-metric near-tie; none occurs here)."""
    frozen, logits = _crc_logits(n, n // 2, 96, seed=n + L)
    kw = dict(list_size=L, crc_degree="CRC11", return_crc_status=True,
              use_fast_scl=fast)
    u_j, ok_j = JPolarSCLDecoder(frozen, n, **kw)(jnp.asarray(logits))
    dec = PolarSCLDecoder(frozen, n, device="cpu", **kw)
    u_t, ok_t = dec(torch.from_numpy(logits))
    assert u_t.shape == (96, n // 2) and ok_t.dtype == torch.bool
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


@pytest.mark.parametrize("sweep,L", [("fast", 32), ("plain", 16)])
def test_wide_list_sweep_equals_jax(sweep, L):
    """L = 16, 32 through the port's sweeps (rate-1 nodes on the fast one)
    against JAX's XLA sweeps on random blocks, min-sum."""
    n, k, b = 128, 64, 3        # the plain sweep's 16 units run traced
    frozen, _ = generate_5g_ranking(k, n)
    mask = np.zeros(n, bool)
    mask[frozen] = True
    llr = _llr_ch(n, 32, L)
    if sweep == "fast":
        u_j, pm_j = jsc.scl_sweep_hybrid_fast(
            jnp.asarray(llr), mask, L, lower_stages=b, use_pallas=False,
            rate1=True)
        u_t, pm_t = tsc.scl_sweep_hybrid_fast(
            torch.from_numpy(llr), mask, L, lower_stages=b, rate1=True)
    else:
        u_j, pm_j = jsc.scl_sweep_hybrid(jnp.asarray(llr), mask, L,
                                         lower_stages=b, use_pallas=False)
        u_t, pm_t = tsc.scl_sweep_hybrid(torch.from_numpy(llr), mask, L,
                                         lower_stages=b)
    assert_blocks_agree((np.asarray(u_j),), (u_t.numpy(),), np.asarray(pm_j),
                        pm_t.numpy())


@pytest.mark.parametrize("subtree", ["plain", "host"])
def test_plain_sweep_traced_units_equal_static_units(subtree):
    """With more than ``UNROLL_OUTER_MAX_M`` subtrees the plain sweep runs
    them on one traced schedule with the frozen flags as data; the result
    is bit-identical to the static leaf-only units."""
    n, k, L, b = 256, 128, 8, 4
    frozen, _ = generate_5g_ranking(k, n)
    mask = np.zeros(n, bool)
    mask[frozen] = True
    traced = tsc.plan_plain_sweep(mask, b, "cpu")
    assert len(traced) == 16 > tsc.UNROLL_OUTER_MAX_M
    assert all(u[2].traced and u[3] is not None for u in traced)
    static = tsc.plan_sweep(tsc.leaf_schedule(mask), b, "cpu")
    assert not any(u[2].traced for u in static if u[0] == "sub")
    assert not any(u[2].traced for u in tsc.plan_plain_sweep(mask, 5, "cpu"))
    llr = torch.from_numpy(_llr_ch(n, 64, 31))
    kw = {} if subtree == "plain" else {"subtree": scl_subtree_host}
    u_s, pm_s = tsc.scl_sweep_hybrid(llr, mask, L, lower_stages=b,
                                     plan=static, **kw)
    u_t, pm_t = tsc.scl_sweep_hybrid(llr, mask, L, lower_stages=b,
                                     plan=traced, **kw)
    assert torch.equal(u_s, u_t) and torch.equal(pm_s, pm_t)


def test_wide_lists_take_their_own_default_depth():
    frozen, _ = generate_5g_ranking(512, 1024)
    for L in (8, 16, 32):
        dec = PolarSCLDecoder(frozen, 1024, list_size=L, device="cpu")
        assert dec.lower_stages == tsc.default_lower_stages(L)
    assert tsc.default_lower_stages(8) == tsc.DEFAULT_LOWER_STAGES
    assert tsc.default_lower_stages(32) == tsc.DEFAULT_WIDE_LOWER_STAGES


def test_entry_points_default_to_the_card():
    frozen, _ = generate_5g_ranking(32, 64)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PolarSCLDecoder(frozen, 64)


def test_from_numpy_state_equals_jax_chain():
    """The JAX objects' attributes build the port's chain; both encode and
    decode the same code to the same bits."""
    n, k = 128, 64
    frozen, _ = j_generate_5g_ranking(k, n)
    j_enc = JPolarEncoder(frozen, n)
    j_dec = JPolarSCLDecoder(frozen, n, list_size=8, mode="minsum",
                             schedule="unrolled", use_fast_scl=True,
                             fast_rate1=True)
    model = from_numpy_state(dict(
        frozen_pos=np.asarray(j_dec.frozen_pos), n=j_dec.n, k=j_dec.k,
        list_size=j_dec.list_size, mode=j_dec.mode, llr_max=j_dec.llr_max,
        fast_rate1=j_dec.fast_rate1, spc_min_stage=None), device="cpu")
    assert model.decoder.fast_rate1 and model.k == k
    u = np.random.default_rng(4).integers(0, 2, (32, k)).astype(np.float32)
    c = model.encoder(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(c, np.asarray(j_enc(jnp.asarray(u))))
    logits = -_llr_ch(n, 32, 8).T
    np.testing.assert_array_equal(
        model.decoder(torch.from_numpy(logits)).numpy(),
        np.asarray(j_dec(jnp.asarray(logits))))


def test_chain_decodes_at_high_snr():
    frozen, _ = generate_5g_ranking(64, 128)
    model = from_numpy_state(dict(
        frozen_pos=frozen, n=128, k=64, list_size=8, mode="minsum",
        llr_max=30.0, fast_rate1=True, spc_min_stage=None), device="cpu")
    bits, bits_hat = model.step(torch.Generator().manual_seed(0), 256, 5.0)
    assert bits_hat.shape == (256, 64) and bits_hat.dtype == torch.float32
    assert count_block_errors(bits, bits_hat).item() == 0


def test_import_leaves_jax_out():
    code = ("import sys, polar_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'polar_tpu'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True)


def _port_sources():
    root = os.path.join(REPO, "polar_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    examples = os.path.join(REPO, "examples")
    for fn in sorted(os.listdir(examples)):
        if fn.startswith("torch_") and fn.endswith(".py"):
            yield os.path.join(examples, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax_and_read_no_tpu_env():
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|polar_tpu)\b",
                         re.M)
    for path in _port_sources():
        with open(path) as fh:
            text = fh.read()
        assert not imports.search(text), path
        assert "POLAR_TPU_" not in text, path
