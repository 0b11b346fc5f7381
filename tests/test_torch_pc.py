"""PC-aided SC/SCL decoding of polar_torch (the 5G uplink codes with
12 <= k <= 19, TS 38.212 5.3.1.2) against polar_tpu on JAX-CPU.

The same NumPy logits go through the JAX package's unrolled PC decoders
and the port's, at the decoder level (``pc_pos``) and through
``Polar5GDecoder`` (rate recovery, CRC6, 3 PC bits). The contract:

* SC in min-sum bit-equal, in exact mode on ``BLOCK_AGREEMENT`` of blocks
  (the exact boxplus rounds differently in torch and XLA);
* SCL and hybSCL: decisions and CRC status equal on every block but those
  where the port's own decode meets a near-tie, two competing candidate
  metrics within ``PM_RTOL`` (the softplus tolerance);
* the g++ host builds of both kernels with ``'p'`` leaves against their
  plain versions, bit for bit in min-sum;
* the per-path register against ``tests/test_pc.py``'s plain twin of the
  TS 38.212 register, and the noiseless round trip with its CRC status.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.models.polar.decode5g import Polar5GDecoder as JPolar5GDecoder
from polar_tpu.models.polar.encode import Polar5GEncoder as JPolar5GEncoder
from polar_tpu.models.polar.hybrid import HybridSCLDecoder as JHybrid
from polar_tpu.models.polar.sc import PolarSCDecoder as JPolarSCDecoder
from polar_tpu.models.polar.scl import PolarSCLDecoder as JPolarSCLDecoder

from polar_torch import Polar5GDecoder, Polar5GEncoder
from polar_torch.models.polar import cuda_scl, scan_core
from polar_torch.models.polar.cuda_sc import (sc_schedule, sc_subtree_host,
                                              sc_subtree_plain)
from polar_torch.models.polar.cuda_scl import (
    MAX_B, SubtreeSchedule, scl_subtree_host, scl_subtree_plain)
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder
from polar_torch.ops.butterfly import polar_transform

from _torch_parity import BLOCK_AGREEMENT, PM_RTOL
from test_pc import _register_reference

BS = 96
# (k, E) of the uplink codes (n_polar 64, 64 and 256): the channel's
# noise std, where a share of the blocks fails
CODES = {(16, 64): 1.0, (12, 48): 1.0, (19, 256): 0.5}


def _chain(k, e, bs=BS, seed=0):
    """The port's encoder of the (k, E) uplink code and the logits of its
    codewords of random payloads over BPSK and AWGN (noise std
    ``CODES[k, e]``); the payloads."""
    enc = Polar5GEncoder(k, e, device="cpu")
    assert enc.pc_pos is not None and enc.n_polar <= 256
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (bs, k)).astype(np.float32)
    c = enc(torch.from_numpy(u)).numpy()
    sigma = CODES[k, e]
    y = (2.0 * c - 1.0) + rng.normal(0, sigma, c.shape)
    return enc, ((2.0 / sigma ** 2) * y).astype(np.float32), u


def _mother(k, e, seed=0):
    """(frozen positions, PC positions, n_polar, rate-recovered logits
    [bs, n_polar]) of the code: the decoder-level inputs."""
    enc, logits, _ = _chain(k, e, seed=seed)
    front = Polar5GDecoder(enc, dec_type="SC").rate_recover(
        torch.from_numpy(logits)).numpy()
    return enc.frozen_pos, enc.pc_pos, enc.n_polar, front


class _NearTies:
    """Records, over the plain SCL version's forks, which blocks pick
    between two candidates whose metrics lie within ``PM_RTOL``."""

    def __init__(self, monkeypatch):
        self.blocks = None
        top_l = cuda_scl._top_l

        def recording(pmc, L):
            srt = torch.sort(pmc, dim=0).values
            tie = ((srt[L] - srt[L - 1]).abs()
                   <= PM_RTOL * srt[L].abs().clamp_min(1.0))
            self.blocks = tie if self.blocks is None else self.blocks | tie
            return top_l(pmc, L)

        monkeypatch.setattr(cuda_scl, "_top_l", recording)


def _assert_equal_but_near_ties(got, want, ties):
    """Rows of ``got`` and ``want`` (arrays or tuples of arrays with the
    blocks first) differ only on near-tie blocks."""
    bad = np.zeros(len(ties), bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        bad |= (g != w).reshape(len(ties), -1).any(-1)
    assert not (bad & ~ties).any(), (
        f"blocks {np.flatnonzero(bad & ~ties).tolist()} differ with no "
        f"near-tie fork")
    return int(bad.sum())


@pytest.mark.parametrize("mode", ["minsum", "exact"])
@pytest.mark.parametrize("code", list(CODES), ids=lambda c: f"k{c[0]}_e{c[1]}")
def test_sc_equals_jax(code, mode):
    frozen, pc_pos, n, llr = _mother(*code)
    want = np.asarray(JPolarSCDecoder(frozen, n, mode=mode, pc_pos=pc_pos)(
        jnp.asarray(llr)))
    dec = PolarSCDecoder(frozen, n, mode=mode, pc_pos=pc_pos, device="cpu")
    got = dec(torch.from_numpy(llr)).numpy()
    assert got.shape == want.shape == (BS, code[0] + 6) == (BS, dec.k)
    assert dec.lower_stages == n.bit_length() - 1
    if mode == "minsum":
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).all(-1).mean() >= BLOCK_AGREEMENT


@pytest.mark.parametrize("code,L,mode", [
    ((16, 64), 4, "minsum"), ((16, 64), 8, "minsum"), ((16, 64), 4, "exact"),
    ((16, 64), 8, "exact"), ((12, 48), 8, "minsum"), ((12, 48), 4, "exact")],
    ids=lambda v: f"k{v[0]}_e{v[1]}" if isinstance(v, tuple) else str(v))
def test_ca_scl_equals_jax(code, L, mode, monkeypatch):
    frozen, pc_pos, n, llr = _mother(*code, seed=L)
    kw = dict(list_size=L, crc_degree="CRC6", mode=mode,
              return_crc_status=True, pc_pos=pc_pos)
    u_j, ok_j = JPolarSCLDecoder(frozen, n, **kw)(jnp.asarray(llr))
    ties = _NearTies(monkeypatch)
    dec = PolarSCLDecoder(frozen, n, device="cpu", **kw)
    u_t, ok_t = dec(torch.from_numpy(llr))
    assert not dec.use_fast_scl and dec.lower_stages == n.bit_length() - 1
    assert u_t.shape == (BS, dec.k) == (BS, code[0] + 6)
    _assert_equal_but_near_ties((u_t.numpy(), ok_t.numpy()),
                                (np.asarray(u_j), np.asarray(ok_j)),
                                ties.blocks.numpy())


@pytest.mark.parametrize("code,mode", [((16, 64), "minsum"),
                                       ((12, 48), "exact")],
                         ids=["k16_e64-minsum", "k12_e48-exact"])
def test_hybrid_equals_jax(code, mode, monkeypatch):
    """hybSCL-4: SC on every block, CA-SCL on those whose CRC fails; the
    near-tie blocks come from a full-batch CA-SCL decode of the same
    logits, which gives a re-decoded row the same bits."""
    frozen, pc_pos, n, llr = _mother(*code, seed=3)
    kw = dict(list_size=4, crc_degree="CRC6", mode=mode,
              return_crc_status=True, pc_pos=pc_pos)
    u_j, ok_j = JHybrid(frozen, n, **kw)(jnp.asarray(llr))
    u_t, ok_t = HybridSCLDecoder(frozen, n, device="cpu", **kw)(
        torch.from_numpy(llr))
    ties = _NearTies(monkeypatch)
    PolarSCLDecoder(frozen, n, device="cpu", **kw)(torch.from_numpy(llr))
    assert not bool(ok_t.all()) and u_t.shape == (BS, code[0] + 6)
    _assert_equal_but_near_ties((u_t.numpy(), ok_t.numpy()),
                                (np.asarray(u_j), np.asarray(ok_j)),
                                ties.blocks.numpy())


@pytest.mark.parametrize("dec_type", ["SC", "SCL", "hybSCL"])
def test_5g_decoder_equals_jax(dec_type, monkeypatch):
    """The slice as a whole: ``Polar5GDecoder`` on the (12, 48) uplink
    code (rate recovery, PC-aided decode, CRC6 check and strip), CA status
    included, against the JAX package's."""
    enc, logits, _ = _chain(12, 48, seed=5)
    j_dec = JPolar5GDecoder(JPolar5GEncoder(12, 48), dec_type=dec_type,
                            list_size=4, return_crc_status=True)
    u_j, ok_j = j_dec(jnp.asarray(logits))
    ties = _NearTies(monkeypatch)
    dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=4,
                         return_crc_status=True)
    u_t, ok_t = dec(torch.from_numpy(logits))
    if dec_type == "hybSCL":     # a full-batch CA-SCL decode's near-ties
        ties = _NearTies(monkeypatch)
        Polar5GDecoder(enc, dec_type="SCL", list_size=4)(
            torch.from_numpy(logits))
    assert u_t.shape == (BS, 12) and 0 < int(ok_t.sum()) < BS
    if dec_type == "SC":
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        return
    _assert_equal_but_near_ties((u_t.numpy(), ok_t.numpy()),
                                (np.asarray(u_j), np.asarray(ok_j)),
                                ties.blocks.numpy())


@pytest.mark.parametrize("dec_type,L", [("SC", 1), ("SCL", 8),
                                        ("hybSCL", 4)])
@pytest.mark.parametrize("code", [(12, 48), (16, 64), (19, 256)],
                         ids=lambda c: f"k{c[0]}_e{c[1]}")
def test_noiseless_round_trip_and_crc_status(code, dec_type, L):
    """The noiseless +-10 logits of encoded payloads decode to the
    payloads with the CRC passing, as ``tests/test_pc.py`` holds JAX's."""
    enc, _, u = _chain(*code, bs=16, seed=7)
    logits = 10.0 * (2.0 * enc(torch.from_numpy(u)) - 1.0)
    kw = {} if dec_type == "SC" else {"list_size": L}
    dec = Polar5GDecoder(enc, dec_type=dec_type, return_crc_status=True,
                         **kw)
    u_hat, ok = dec(logits)
    np.testing.assert_array_equal(u_hat.numpy(), u)
    assert ok.dtype == torch.bool and bool(ok.all())


@pytest.mark.parametrize("version", ["sc_plain", "sc_host", "scl_plain",
                                     "scl_host"])
def test_register_equals_the_reference_twin(version):
    """Noiseless decodes of random PC-expanded words: every decision,
    the PC leaves' included, equals the plain twin of the TS 38.212
    register (``tests/test_pc.py``), on random masks at n = 128."""
    rng = np.random.default_rng(11)
    n, b, bs = 128, 7, 32
    is_data = rng.random(n) < 0.4
    is_pc = ~is_data & (rng.random(n) < 0.15)
    frozen = ~(is_data | is_pc)
    u = np.where(is_data, rng.integers(0, 2, (bs, n)), 0).astype(np.float32)
    u = _register_reference(u, is_data, is_pc)          # [bs, n]
    c = polar_transform(torch.from_numpy(u.T.astype(np.int8)), axis=0)
    llr = (10.0 * (1.0 - 2.0 * c.to(torch.float32))).contiguous()  # true
    if version.startswith("sc"):
        ops = scan_core.fast_schedule(frozen, rep=False, pc_mask=is_pc)
        kw = dict(b=b, llr_max=30.0, mode="minsum")
        cw = (sc_subtree_plain(llr, None, ops, **kw) if version == "sc_plain"
              else sc_subtree_host(llr, None, sc_schedule(ops, "cpu"), **kw))
    else:
        L = 4
        ops = scan_core.leaf_schedule(frozen, is_pc)
        a = llr[:, None, :].expand(n, L, bs).contiguous()
        pm = torch.full((L, bs), 30.0)
        pm[0] = 0.0
        kw = dict(b=b, llr_max=30.0, mode="minsum")
        fn = scl_subtree_plain if version == "scl_plain" else \
            lambda *x, **k: scl_subtree_host(x[0], x[1],
                                             SubtreeSchedule(x[2], "cpu"),
                                             **k)
        cw, _, pm_out = fn(a, pm, ops, **kw)
        best = pm_out.argmin(0)
        assert bool((best == 0).all())
        cw = cw[:, 0]
    got = polar_transform(cw.to(torch.int8), axis=0).numpy().T
    np.testing.assert_array_equal(got, u.astype(np.int8))


@pytest.mark.parametrize("b", [5, 6, 7, 8])
def test_host_builds_with_pc_leaves_equal_plain(b):
    """The g++ builds of both kernels' routines with ``'p'`` leaves on
    random masks against their plain versions: SCL at L = 2, 8 and 32,
    SC with 4, 8 and 32 lanes and with every workspace stage in the global
    scratch; min-sum, bit for bit (path metrics to ``PM_RTOL``)."""
    rng = np.random.default_rng(b)
    n = 1 << b
    frozen = rng.random(n) < 0.5
    pc = np.zeros(n, bool)
    pc[rng.choice(np.flatnonzero(~frozen), 4, replace=False)] = True
    ops = scan_core.leaf_schedule(frozen, pc)
    assert sum(k == "p" for k, _, _ in ops) == 4
    kw = dict(b=b, llr_max=30.0, mode="minsum")
    for L in (2, 8, 32):
        a = torch.from_numpy(rng.normal(0, 3, (n, L, 64)).astype(np.float32))
        pm = torch.from_numpy(rng.exponential(2, (L, 64)).astype(np.float32))
        want = scl_subtree_plain(a, pm, ops, **kw)
        got = scl_subtree_host(a, pm, SubtreeSchedule(ops, "cpu"), **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(),
                                   rtol=PM_RTOL)
    sc_ops = scan_core.fast_schedule(frozen, rep=False, pc_mask=pc)
    a = torch.from_numpy(rng.normal(0, 3, (n, 100)).astype(np.float32))
    want = sc_subtree_plain(a, None, sc_ops, **kw)
    for lanes, n_shared in ((4, None), (8, None), (32, None), (4, 0)):
        got = sc_subtree_host(a, None, sc_schedule(sc_ops, "cpu"),
                              lanes=lanes, n_shared=n_shared, **kw)
        assert torch.equal(got, want)


def test_schedules_carry_the_pc_leaves():
    frozen = np.array([1, 1, 0, 0, 1, 0, 0, 0], bool)
    pc = np.array([0, 0, 0, 1, 0, 0, 1, 0], bool)
    assert scan_core.leaf_schedule(frozen, pc) == [
        ("f", 0, 0), ("f", 0, 1), ("i", 0, 2), ("p", 0, 3), ("f", 0, 4),
        ("i", 0, 5), ("p", 0, 6), ("i", 0, 7)]
    assert scan_core.fast_schedule(frozen, rep=False, pc_mask=pc)[0] == (
        "z", 1, 0)
    # a node holding a PC leaf is never pruned but into rate-0 spans
    ops = scan_core.fast_schedule(frozen, rate1=True, spc_min_stage=1,
                                  pc_mask=pc)
    assert ("o", 1, 6) not in ops and ("p", 0, 6) in ops
    assert ("r", 1, 2) not in ops and ("p", 0, 3) in ops
    assert scan_core.fast_schedule(frozen, rate1=True)[1:] == [
        ("o", 1, 2), ("r", 1, 4), ("o", 1, 6)]
    assert cuda_scl.KIND_CODES["p"] == 7
    # PC leaves need the whole tree in one subtree call
    with pytest.raises(ValueError, match="whole tree"):
        scan_core.plan_sweep(scan_core.leaf_schedule(frozen, pc), 2, "cpu")
    with pytest.raises(ValueError, match="frozen"):
        scan_core.leaf_schedule(frozen, np.roll(pc, -3))


def test_pc_decoders_raise_value_errors():
    enc = Polar5GEncoder(16, 64, device="cpu")
    frozen, pc_pos, n = enc.frozen_pos, enc.pc_pos, enc.n_polar
    with pytest.raises(ValueError, match="frozen"):
        PolarSCDecoder(frozen, n, pc_pos=frozen[:1], device="cpu")
    with pytest.raises(ValueError, match="whole tree"):
        PolarSCDecoder(frozen, n, pc_pos=pc_pos, lower_stages=3,
                       device="cpu")
    with pytest.raises(ValueError, match="whole tree"):
        PolarSCLDecoder(frozen, n, pc_pos=pc_pos, lower_stages=5,
                        device="cpu")
    for kw in ({"fast_rate1": True}, {"spc_min_stage": 2}):
        with pytest.raises(ValueError, match="fast sweep"):
            PolarSCLDecoder(frozen, n, pc_pos=pc_pos, device="cpu", **kw)
    big = 1 << (MAX_B + 1)
    with pytest.raises(ValueError, match="whole tree"):
        PolarSCDecoder(np.arange(big // 2), big, pc_pos=[big - 1],
                       device="cpu")
    with pytest.raises(ValueError, match="outside"):
        PolarSCDecoder(frozen, n, pc_pos=[n], device="cpu")
    # an explicit depth of log2(n) is the PC depth; fast is forced off
    dec = PolarSCLDecoder(frozen, n, pc_pos=pc_pos, lower_stages=6,
                          use_fast_scl=True, device="cpu")
    assert not dec.use_fast_scl and dec.k == 22
    np.testing.assert_array_equal(dec.pc_pos, pc_pos)
