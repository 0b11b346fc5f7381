"""The polar_torch OSD decoder against polar_tpu's: the reference fixtures
bit for bit, random LLRs under the tie rule, a batch built to tie (stable
sorts), and the decoding properties of ``tests/test_osd.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.osd import OSDecoder as JOSDecoder
from polar_tpu.models.polar.encode import PolarEncoder as JPolarEncoder

from _torch_parity import assert_osd_agrees, osd_distance
from polar_torch.models import osd as tosd
from polar_torch.models.osd import OSDecoder
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.encode import PolarEncoder


def _codes(k, n, **kw):
    frozen, _ = generate_5g_ranking(k, n)
    enc = PolarEncoder(frozen, n, device="cpu")
    return enc, JPolarEncoder(frozen, n)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_osd_equals_reference_fixture(osd_fix, t):
    enc = PolarEncoder(osd_fix["frozen_pos"], 32, device="cpu")
    got = OSDecoder(t=t, encoder=enc)(torch.from_numpy(osd_fix[f"t{t}_llr"]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), osd_fix[f"t{t}_chat"])


@pytest.mark.parametrize("k,n,chunk", [(16, 32, 4096), (64, 128, 1024)])
def test_osd_equals_jax_on_random_llrs(k, n, chunk):
    enc, j_enc = _codes(k, n)
    dec = OSDecoder(t=2, encoder=enc, pattern_chunk=chunk)
    j_dec = JOSDecoder(t=2, encoder=j_enc, pattern_chunk=chunk)
    np.testing.assert_array_equal(dec._pattern_chunks, j_dec._pattern_chunks)
    if chunk == 1024:
        assert dec._pattern_chunks.shape[0] > 1
    llr = np.random.default_rng(n).normal(0, 2, (16, n)).astype(np.float32)
    got = dec(torch.from_numpy(llr)).numpy()
    want = np.asarray(j_dec(jnp.asarray(llr)))
    assert_osd_agrees(llr, got, want, llr_max=100.0)
    assert bool(enc.parity_check(torch.from_numpy(got)).all())


def _tied_llrs(n, k, bs, seed, group):
    """Random LLRs whose reliability sort ties: in each block the 6 most
    reliable values become +-150 (clipped to +-100) and ``group`` values
    around the k-th most reliable share its magnitude, so the tie straddles
    the edge of the most reliable basis. ``group`` stays below the code's
    minimum distance, so no two codewords tie in distance."""
    rng = np.random.default_rng(seed)
    llr = rng.normal(0, 2, (bs, n)).astype(np.float32)
    for b in range(bs):
        order = np.argsort(-np.abs(llr[b]), kind="stable")
        mid = order[k - group // 2:k - group // 2 + group]
        llr[b, mid] = np.abs(llr[b, order[k]]) * np.sign(llr[b, mid])
        llr[b, order[:6]] = 150.0 * np.sign(llr[b, order[:6]])
    return llr


def test_osd_equals_jax_exactly_on_tied_llrs(monkeypatch):
    """Every block's reliability sort ties (the 5G (32, 64) code, minimum
    distance 8, ties of 7): both packages sort stably, so they agree
    exactly; breaking the ties the other way changes some blocks."""
    k, n = 32, 64
    enc, j_enc = _codes(k, n)
    llr = _tied_llrs(n, k, 32, 0, 7)
    for t in (0, 1, 2):
        got = OSDecoder(t=t, encoder=enc)(torch.from_numpy(llr)).numpy()
        want = np.asarray(JOSDecoder(t=t, encoder=j_enc)(jnp.asarray(llr)))
        np.testing.assert_array_equal(got, want)
    argsort = torch.argsort

    def ties_last_first(x, dim=-1, stable=False):
        rev = argsort(torch.flip(x, [dim]), dim=dim, stable=True)
        return x.shape[dim] - 1 - rev

    monkeypatch.setattr(tosd.torch, "argsort", ties_last_first)
    other = OSDecoder(t=2, encoder=enc)(torch.from_numpy(llr)).numpy()
    assert (other != got).any()


def test_osd_outputs_valid_codewords_and_round_trips():
    enc, _ = _codes(16, 32)
    dec = OSDecoder(t=2, encoder=enc)
    rng = np.random.default_rng(1)
    llr = torch.from_numpy(rng.normal(0, 2, (32, 32)).astype(np.float32))
    assert bool(enc.parity_check(dec(llr)).all())
    u = torch.from_numpy(rng.integers(0, 2, (8, 16)).astype(np.float32))
    c = enc(u)
    np.testing.assert_array_equal(
        OSDecoder(t=1, encoder=enc)((2.0 * c - 1.0) * 8.0).numpy(),
        c.numpy())


def test_osd_higher_order_never_worse():
    enc, _ = _codes(16, 32)
    llr = np.random.default_rng(3).normal(0, 1.5, (64, 32)).astype(
        np.float32)
    d = {t: osd_distance(llr, OSDecoder(t=t, encoder=enc)(
        torch.from_numpy(llr)).numpy(), 100.0) for t in (0, 2)}
    assert np.all(d[2] <= d[0] + 1e-6)


def test_sweep_in_pieces_equals_whole_chunks(monkeypatch):
    """Pieces smaller than a chunk (a workspace budget of a few patterns)
    give the same codewords as whole chunks: the first minimum wins inside
    a piece and only a strictly better piece replaces the best."""
    enc, _ = _codes(64, 128)
    llr = np.random.default_rng(9).normal(0, 2, (8, 128)).astype(np.float32)
    # a tie-heavy half, so the first-minimum rule is exercised
    llr[4:] = np.round(llr[4:])
    dec = OSDecoder(t=2, encoder=enc, pattern_chunk=1024)
    whole = dec(torch.from_numpy(llr)).numpy()
    for patterns in (1, 7, 300):
        monkeypatch.setattr(tosd, "SWEEP_BYTES", 9 * 8 * 128 * patterns)
        np.testing.assert_array_equal(dec(torch.from_numpy(llr)).numpy(),
                                      whole)


def test_osd_checks_and_leading_dims(capsys):
    with pytest.raises(AttributeError):
        OSDecoder(t=1, encoder=None)
    with pytest.raises(ValueError):
        OSDecoder(t=-1, encoder=_codes(16, 32)[0])
    # the counts go by n: 2.2e7 patterns of weight <= 3 at n=512 (a note),
    # 1.8e8 at n=1024 (refused); k=8 keeps the pattern list itself small
    OSDecoder(t=3, encoder=_codes(8, 512)[0])
    assert "OSD complexity is large" in capsys.readouterr().out
    with pytest.raises(ResourceWarning):
        OSDecoder(t=3, encoder=_codes(8, 1024)[0])
    enc, _ = _codes(16, 32)
    dec = OSDecoder(t=1, encoder=enc)
    llr = torch.from_numpy(np.random.default_rng(2).normal(
        0, 2, (6, 32)).astype(np.float32))
    np.testing.assert_array_equal(dec(llr.reshape(2, 3, 32)).numpy(),
                                  dec(llr).reshape(2, 3, 32).numpy())
    with pytest.raises(ValueError):
        dec(llr[:, :16])
    assert (dec.k, dec.n, dec.device.type) == (16, 32, "cpu")
