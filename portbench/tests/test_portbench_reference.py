"""The plain reference against the port on the CPU, at n = 64 and 256
(and the UCI codes' N = 128 and 256): the same draws, codewords, LLRs to
rounding, and the same decisions on every block."""

import numpy as np
import pytest
import torch

import polar_torch as pt
from polar_torch.models.polar.scan_core import fast_schedule, leaf_schedule
from portbench import reference
from portbench.reference import channel, nr
from portbench.reference.polar_awgn import Link
from portbench.systems import polar_awgn

BASE = {"system": "polar_awgn", "list_size": 8, "llr_max": 30.0}
CASES = [
    (dict(BASE, code="5g_ranked", k=32, n=64, decoder="scl",
          mode="minsum", fast_scl=True, fast_rate1=True), 1.0, 256),
    (dict(BASE, code="5g_ranked", k=128, n=256, decoder="scl",
          mode="minsum", fast_scl=True, fast_rate1=True), 1.5, 128),
    (dict(BASE, code="5g_uci", k=12, n=140, decoder="5g_cascl",
          mode="exact", fast_scl=False, fast_rate1=False), 0.0, 256),
    (dict(BASE, code="5g_uci", k=19, n=864, decoder="5g_cascl",
          mode="exact", fast_scl=False, fast_rate1=False), 2.0, 128),
]
IDS = ["ranked_n64", "ranked_n256", "uci_a12_e140", "uci_a19_e864"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_reference_equals_port(case, seed):
    cfg, ebno, bs = case
    model = polar_awgn.build(cfg, torch.device("cpu"))
    ref = reference.link(cfg, "cpu")      # found by cfg["system"]
    assert isinstance(ref, Link)
    s = channel.batch_seed(seed, 0, 3)
    bits, cw, llr = model.front(torch.Generator("cpu").manual_seed(s), bs,
                                ebno)
    bits_hat = model.decoder(llr)
    rb, rcw, rllr = ref.front(s, bs, ebno, torch.float64)
    assert torch.equal(bits.to(torch.int64), rb)
    assert torch.equal(cw.to(torch.int8), rcw)
    err = (llr.double() - rllr).abs().max() / rllr.abs().mean()
    assert err < 1e-5
    rbh = ref.decode(rllr)
    assert torch.equal(bits_hat.to(torch.int8), rbh)
    # the point is one where decisions matter: some blocks are wrong
    assert (rbh != rb.to(torch.int8)).any(dim=1).sum() > 0


@pytest.mark.parametrize("a,e", [(12, 140), (19, 864), (19, 600)])
def test_uci_construction_equals_port(a, e):
    code = nr.UciCode(a, e)
    enc = pt.Polar5GEncoder(a, e, device="cpu")
    assert code.n == enc.n_polar
    assert np.array_equal(code.info, enc.info_pos)
    assert np.array_equal(code.pc, enc.pc_pos)
    assert np.array_equal(code.rm, enc._ind_rate_matching)


def test_crc6_divides_the_codeword():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (50, 19))
    w = np.concatenate([a, nr.crc_parity(a, "CRC6")], axis=1)
    # the word's polynomial leaves no remainder: its own parity is zero
    # after the 6 parity bits shift through
    full = nr.crc_parity(w, "CRC6")
    assert not full.any()
    enc = pt.CRCEncoder("CRC6", k=19)
    ours = torch.from_numpy(w).float()
    assert torch.equal(enc(torch.from_numpy(a).float()), ours)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_schedule_equals_port(case):
    cfg = case[0]
    link = Link(cfg, "cpu")
    mask = np.array(link.dec.frozen)
    kinds = {"z": "rate0", "r": "rep", "o": "rate1", "f": "frozen",
             "i": "info", "p": "pc"}
    if cfg["fast_scl"]:
        ops = fast_schedule(mask, rate1=cfg["fast_rate1"])
    else:
        ops = leaf_schedule(mask, np.array(link.dec.pc))
    assert [(kinds[k], s, lo) for k, s, lo in ops] == link.dec.schedule()


def test_bfloat16_reference_decides_otherwise():
    # the control's premise: bf16 LLRs and metrics change decisions
    cfg, ebno, bs = CASES[3]
    s = channel.batch_seed(9, 0, 0)
    rb, nr_, ni = channel.draws(s, 512, cfg["k"], cfg["n"] // 2, "cpu")
    no = channel.noise_variance(ebno, cfg["k"], cfg["n"])
    f32, bf16 = Link(cfg, "cpu"), Link(cfg, "cpu", torch.bfloat16)
    cw = f32.encode(rb)
    a = f32.decode(channel.qpsk_awgn_llr(cw, nr_, ni, no,
                                         torch.float64).float())
    b = bf16.decode(channel.qpsk_awgn_llr(cw, nr_, ni, no,
                                          torch.bfloat16))
    assert (a != b).any(dim=1).sum() > 10
