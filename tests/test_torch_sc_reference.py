"""The port's SC decode against the benchmark's plain SC reference
(``portbench/reference/polar_sc.py``, a recursion over the whole code tree
written from Arikan's description and importing nothing of the port), on
seeded random LLRs with exact zeros of both signs and values far beyond
+-``llr_max``: the decisions bit for bit, through the port's normal CPU
path (``PolarSCDecoder`` -> ``sc_subtree_plain``) and the kernel's host
build (``sc_sweep_hybrid(..., subtree=sc_subtree_host)``), with the tree
cut below its root and whole. Also the reference's least work by a hand
count, and the sweep's ``rows.sc.top`` counter by a plain count of its
plan."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_sc import sc_subtree_host
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scan_core import plan_sc_sweep, sc_sweep_hybrid
from polar_torch.utils import tracing
from portbench.reference import polar_sc

LLR_MAX = 30.0
BS = 300


def _cfg(k, n):
    return {"system": "polar_sc", "code": "5g_ranked", "k": k, "n": n,
            "decoder": "sc", "mode": "minsum", "llr_max": LLR_MAX}


def _logits(n, seed):
    """[BS, n] logits (positive means 1): wide Gaussians, a tenth of them
    exact zeros of either sign, and a column of +-10^4."""
    g = torch.Generator().manual_seed(seed)
    x = 15.0 * torch.randn(BS, n, generator=g)
    zero = torch.rand(BS, n, generator=g) < 0.1
    sign = torch.where(torch.rand(BS, n, generator=g) < 0.5, 1.0, -1.0)
    x = torch.where(zero, 0.0 * sign, x)
    x[:, n // 2] = 1e4 * sign[:, 0]
    return x


def _mask(k, n):
    mask = np.zeros(n, dtype=bool)
    mask[generate_5g_ranking(k, n)[0]] = True
    return mask


def _host(a, frz, sched, **kw):
    return sc_subtree_host(a.contiguous(), frz, sched, **kw)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("rate", [2, 4])
@pytest.mark.parametrize("route", ["plain", "host"])
@pytest.mark.parametrize("cut", ["below_root", "whole"])
def test_decisions_equal_reference(n, rate, route, cut):
    k = n // rate
    S = n.bit_length() - 1
    b = 3 if cut == "below_root" else S
    link = polar_sc.Link(_cfg(k, n), "cpu")
    logits = _logits(n, 1000 * n + 10 * rate + b)
    assert bool((logits == 0).any()) and bool((logits.abs() > LLR_MAX).any())
    if route == "plain":
        dec = PolarSCDecoder(generate_5g_ranking(k, n)[0], n,
                             llr_max=LLR_MAX, lower_stages=b, device="cpu")
        assert dec.lower_stages == b
        got = dec(logits).to(torch.int8)
        assert torch.equal(got, link.decode(logits, rows=128))
    else:
        llr = (-logits).t().contiguous()
        got = sc_sweep_hybrid(llr, _mask(k, n), llr_max=LLR_MAX,
                              lower_stages=b, subtree=_host)
        assert torch.equal(got, link.dec.decode(llr))
    # the decisions are not all 0 or all 1
    assert 0 < int(got.sum()) < got.numel()


def test_work_by_hand_at_n8():
    # frozen 0 and 2: f 4 + 2 + 2 + 1 + 1 rows, g 4 + 2 + 1 + 1 + 2 + 1 + 1,
    # and the XORs of the sums the g's read: 2 at node [0, 4), 1 at [4, 6)
    mask = np.array([1, 0, 1, 0, 0, 0, 0, 0], dtype=bool)
    assert polar_sc.pruned_work(mask, "minsum") == 8 * 10 + 2 * 12 + 3
    assert polar_sc.pruned_work(mask, "exact") == 20 * 10 + 2 * 12 + 3
    assert polar_sc.pruned_work(np.zeros(8, bool), "minsum") == \
        8 * 12 + 2 * 12 + 5
    assert polar_sc.pruned_work(np.ones(8, bool), "minsum") == 0
    # the (8, 4) code freezes 0, 1, 2 and 4: f 4 + 2 + 1 rows, g 4 + 2 +
    # 1 + 2 + 1 + 1, no XOR (every sum a g reads has a frozen half)
    link = polar_sc.Link(_cfg(4, 8), "cpu")
    assert np.flatnonzero(link.dec.frozen).tolist() == [0, 1, 2, 4]
    assert link.decode_work(100) == (100 * (4 * 8 + 4 * 4),
                                     100 * (8 * 7 + 2 * 11))


def _plain_top_rows(plan, b, S):
    """The rows of every node above stage b on the way from the root to a
    subtree call: each is computed once, by an f or a g."""
    nodes = {(t, unit[1] >> t) for unit in plan if unit[0] == "sub"
             for t in range(S - b)}
    return sum(1 << (b + t) for t, _ in nodes)


def _top_rows(llr, mask, b):
    before = tracing.counter("rows.sc.top")
    sc_sweep_hybrid(llr, mask, lower_stages=b)
    return tracing.counter("rows.sc.top") - before


@pytest.mark.parametrize("b", [9, 10])
def test_top_rows_of_the_cells_code(b):
    mask = _mask(512, 1024)
    llr = torch.randn(1024, 2, generator=torch.Generator().manual_seed(b))
    plan = plan_sc_sweep(mask, b, "cpu")
    assert _top_rows(llr, mask, b) == _plain_top_rows(plan, b, 10) == \
        {9: 1024, 10: 0}[b]


@pytest.mark.parametrize("b", [2, 4, 6])
def test_top_rows_with_frozen_spans_above_the_cut(b):
    # a frozen first half and an eighth: rate-0 nodes above stage b,
    # whose own LLRs the sweep skips
    n = 256
    rng = np.random.default_rng(b)
    mask = rng.random(n) < 0.5
    mask[:128] = True
    mask[160:192] = True
    llr = torch.randn(n, 3, generator=torch.Generator().manual_seed(b))
    plan = plan_sc_sweep(mask, b, "cpu")
    assert any(unit[0] != "sub" for unit in plan)
    with tracing.enabled():
        with tracing.batch():
            got = _top_rows(llr, mask, b)
    assert got == _plain_top_rows(plan, b, 8) > 0
    # charged to the sweep's caller once a decode, on or off
    assert tracing.summary()["spans"]["sim.step"]["rows.sc.top"] == got
