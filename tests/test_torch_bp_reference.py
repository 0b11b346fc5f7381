"""The port's BP decode against the benchmark's plain BP reference
(``portbench/reference/polar_bp.py``, written from the published algorithm
and importing nothing of the port), on the reference's own seeded QPSK /
AWGN LLRs at points where some codewords converge early, some late and
some never: the decisions and the info-side LLRs bit for bit, and the
sweeps each codeword ran, through the port's normal CPU path
(``PolarBPDecoder`` -> ``bp_decode_plain``) and the kernel's host build
(``bp_decode_host``), with early stop and without."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_bp import (bp_decode_host,
                                              bp_decode_plain)
from portbench.reference import polar_bp

LLR_MAX, MSF = 30.0, 0.9375
POINTS = {64: 1.0, 256: 1.5}        # n: Eb/N0 in dB
BS = 192


def _cfg(n, num_iter=20, check_every=2, early_stop=True):
    return {"system": "polar_bp", "code": "5g_ranked", "k": n // 2, "n": n,
            "decoder": "bp", "num_iter": num_iter, "mode": "minsum",
            "msf": MSF, "early_stop": early_stop,
            "check_every": check_every, "llr_max": LLR_MAX}


def _setup(n, early_stop, seed=2 ** 31 + 17):
    cfg = _cfg(n, early_stop=early_stop)
    link = polar_bp.Link(cfg, "cpu")
    _, _, llr = link.front(seed, BS, POINTS[n], torch.float64)
    frozen, _ = generate_5g_ranking(n // 2, n)
    return cfg, link, llr.float(), frozen


def _kw(cfg):
    return dict(num_iter=cfg["num_iter"], check_every=cfg["check_every"],
                early_stop=cfg["early_stop"], mode="minsum", msf=MSF,
                llr_max=LLR_MAX)


def _prior(frozen, n):
    prior = torch.zeros(n)
    prior[torch.as_tensor(np.asarray(frozen, dtype=np.int64))] = LLR_MAX
    return prior


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", sorted(POINTS))
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("route", ["plain", "host"])
def test_decode_equals_reference(n, early_stop, route):
    cfg, link, llr, frozen = _setup(n, early_stop)
    ref_total, _, _ = link.dec.decode((-llr).t().contiguous())
    ref_bits = link.decode(llr)
    if route == "plain":
        dec = PolarBPDecoder(frozen, n, device="cpu", **_kw(cfg))
        assert torch.equal(dec(llr).to(torch.int8), ref_bits)
        total = bp_decode_plain(llr.t(), _prior(frozen, n), negate=True,
                                **_kw(cfg))
    else:
        total = bp_decode_host(llr.t().contiguous(), _prior(frozen, n),
                               negate=True, **_kw(cfg))
    assert torch.equal(_bits(total), _bits(ref_total))
    if early_stop:
        # the point has both kinds of codeword
        _, sweeps, done = link.decode_sweeps(llr)
        assert 0 < int(done.sum()) < BS
        assert int(sweeps.min()) < cfg["num_iter"]


@pytest.mark.parametrize("n", sorted(POINTS))
@pytest.mark.parametrize("early_stop", [True, False])
def test_sweeps_equal_reference(n, early_stop):
    cfg, link, llr, frozen = _setup(n, early_stop)
    _, ref_sweeps, ref_done = link.decode_sweeps(llr)
    prior, true_llr = _prior(frozen, n), (-llr).t().contiguous()
    plain = torch.empty(BS, dtype=torch.int32)
    host = torch.empty(BS, dtype=torch.int32)
    bp_decode_plain(true_llr, prior, sweeps=plain, **_kw(cfg))
    bp_decode_host(true_llr, prior, sweeps=host, **_kw(cfg))
    assert torch.equal(plain.long(), ref_sweeps)
    assert torch.equal(host.long(), ref_sweeps)
    if early_stop:
        _, done = bp_decode_plain(true_llr, prior, return_done=True,
                                  **_kw(cfg))
        assert torch.equal(done.bool(), ref_done)
    else:
        assert bool((ref_sweeps == cfg["num_iter"]).all())


def test_reference_counts_odd_budgets_and_unchecked_tails():
    # 9 sweeps checked every 2: checks at 2..8, then one unchecked sweep
    cfg = _cfg(64, num_iter=9)
    link = polar_bp.Link(cfg, "cpu")
    _, _, llr = link.front(2 ** 31 + 5, BS, 1.0, torch.float64)
    llr = llr.float()
    frozen, _ = generate_5g_ranking(32, 64)
    _, ref_sweeps, ref_done = link.decode_sweeps(llr)
    plain = torch.empty(BS, dtype=torch.int32)
    total = bp_decode_plain((-llr).t().contiguous(), _prior(frozen, 64),
                            sweeps=plain, **_kw(cfg))
    assert torch.equal(plain.long(), ref_sweeps)
    assert set(ref_sweeps[ref_done].tolist()) <= {2, 4, 6, 8}
    assert bool((ref_sweeps[~ref_done] == 9).all())
    ref_total, _, _ = link.dec.decode((-llr).t().contiguous())
    assert torch.equal(_bits(total), _bits(ref_total))


def test_reference_work_at_its_own_mean_sweeps():
    link = polar_bp.Link(_cfg(64), "cpu")
    sweeps, checks = link.mean_sweeps(1.0, blocks=256)
    assert 2 <= sweeps <= 20 and 1 <= checks <= 10
    n_bytes, n_ops = link.decode_work(100, 1.0)
    assert n_bytes == 100 * (4 * 64 + 4 * 32)
    # decode_work takes the mean over its own fixed batch of 1024 blocks
    sweeps, checks = link.mean_sweeps(1.0)
    per_sweep = 2 * 6 * 32 * (2 * 8 + 2 + 2)
    per_check = 5 * 64 + 6 * 32
    assert n_ops == pytest.approx(100 * (sweeps * per_sweep
                                         + checks * per_check))
