"""The sweeps each codeword of a BP decode ran: the optional ``sweeps``
output of the plain version and of the kernel's host build, held against
each other and against the least sweep budget at which a decode reports
the codeword converged, the outputs with it and without it, and the device
counters ``sweeps.bp`` and ``converged.bp`` that ``bp_decode`` feeds while
tracing is on (``tracing.count_on_device``). The kernel's own output is
checked on the card in ``test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar.bp import PolarBPDecoder
from polar_torch.models.polar.construction import (generate_5g_ranking,
                                                   get_kern_frozen_bits)
from polar_torch.models.polar import cuda_bp
from polar_torch.models.polar.cuda_bp import (bp_decode, bp_decode_host,
                                              bp_decode_plain, launch_plan,
                                              resolve_lattice)
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.sim import sim_ber
from polar_torch.utils import tracing

LLR_MAX = 30.0


def _fixture(n, bs, ebno_db, seed):
    """(frozen, prior [n], true LLRs [n, bs]) of random codewords of the 5G
    (n, n/2) code (outside the 5G table's n = 32..1024, the RM-style
    construction), BPSK over AWGN at ``ebno_db``: a point where some
    codewords converge early, some late and some never."""
    k = n // 2
    frozen = (generate_5g_ranking(k, n)[0] if 32 <= n <= 1024
              else get_kern_frozen_bits(n, k)[2])
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.integers(0, 2, (bs, k)).astype(np.float32))
    c = PolarEncoder(frozen, n, device="cpu")(u).numpy()
    sigma = np.sqrt(1.0 / (2 * 10 ** (ebno_db / 10) * (k / n)))
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    prior = np.zeros(n, np.float32)
    prior[frozen] = LLR_MAX
    llr = (2.0 / sigma ** 2 * y).astype(np.float32).T
    return frozen, torch.from_numpy(prior), torch.from_numpy(
        np.ascontiguousarray(llr))


def _kw(num_iter, check_every, early_stop, msg_dtype=torch.float32):
    return dict(num_iter=num_iter, check_every=check_every,
                early_stop=early_stop, mode="minsum", msf=0.9375,
                llr_max=LLR_MAX, msg_dtype=msg_dtype)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


CASES = [  # n, num_iter, check_every, early_stop, ebno_db
    (64, 20, 2, True, 1.0),
    (64, 9, 3, True, 1.5),
    (256, 20, 2, True, 1.5),
    (256, 13, 1, True, 1.0),
    (256, 12, 2, False, 1.5),
    # the tiled form's degenerate groups: S = 1, 2 (fewer rows than a
    # thread owns), 3 (one whole group), 4 (a group of one stage on top),
    # 11 (three groups and one of two stages)
    (2, 7, 2, True, -6.0),
    (4, 9, 3, True, -3.0),
    (8, 11, 1, True, 0.0),
    (16, 13, 2, True, 0.5),
    (2048, 9, 3, True, 5.0),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"n{c[0]}_it{c[1]}_ce{c[2]}_es{int(c[3])}"
                              for c in CASES])
@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_and_host_build_count_alike(case, msg_dtype):
    n, num_iter, check_every, early_stop, ebno = case
    bs = 32 if n == 2048 else 96
    _, prior, llr = _fixture(n, bs, ebno, seed=n + num_iter)
    kw = _kw(num_iter, check_every, early_stop, msg_dtype)
    want = bp_decode_plain(llr, prior, return_done=early_stop, **kw)
    sp = torch.full((bs,), -1, dtype=torch.int32)
    got_p = bp_decode_plain(llr, prior, return_done=early_stop, sweeps=sp,
                            **kw)
    for lattice in ("shared", "global"):
        sh = torch.full((bs,), -1, dtype=torch.int32)
        got_h = bp_decode_host(llr, prior, lattice=lattice,
                               return_done=early_stop, sweeps=sh, **kw)
        assert torch.equal(sh, sp), lattice
        for a, b in zip(got_h if early_stop else [got_h],
                        want if early_stop else [want]):
            assert torch.equal(_bits(a), _bits(b)), lattice
    # the sweeps output leaves every other output as it was
    for a, b in zip(got_p if early_stop else [got_p],
                    want if early_stop else [want]):
        assert torch.equal(_bits(a), _bits(b))
    if early_stop:
        done = want[1].bool()
        assert done.any() and not done.all()
        assert (sp[~done] == num_iter).all()
        assert (sp[done] % check_every == 0).all()
        assert (sp[done] <= num_iter).all()
    else:
        assert (sp == num_iter).all()


@pytest.mark.parametrize("check_every", [1, 2])
def test_sweeps_are_those_of_the_first_check_that_passes(check_every):
    """A codeword stops at the first check that passes: so its count is
    the least budget j (a multiple of check_every) at which a decode of at
    most j sweeps reports it converged, or num_iter where none does."""
    n, num_iter, bs = 64, 12, 64
    _, prior, llr = _fixture(n, bs, 1.0, seed=5)
    sp = torch.empty(bs, dtype=torch.int32)
    bp_decode_plain(llr, prior, sweeps=sp,
                    **_kw(num_iter, check_every, True))
    want = np.full(bs, num_iter)
    found = np.zeros(bs, dtype=bool)
    for j in range(check_every, num_iter + 1, check_every):
        _, done = bp_decode_plain(llr, prior, return_done=True,
                                  **_kw(j, check_every, True))
        first = done.numpy().astype(bool) & ~found
        want[first] = j
        found |= first
    assert found.any() and not found.all()
    np.testing.assert_array_equal(sp.numpy(), want)


def test_sweeps_argument_is_checked():
    _, prior, llr = _fixture(64, 8, 2.0, seed=1)
    kw = _kw(4, 2, True)
    for bad in (torch.empty(8, dtype=torch.int64),
                torch.empty(7, dtype=torch.int32),
                torch.empty(16, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="sweeps"):
            bp_decode_plain(llr, prior, sweeps=bad, **kw)
        with pytest.raises(ValueError, match="sweeps"):
            bp_decode_host(llr, prior, sweeps=bad, **kw)


def test_device_counters_only_in_a_traced_summary():
    _, prior, llr = _fixture(256, 48, 1.5, seed=3)
    kw = _kw(20, 2, True)
    sp = torch.empty(48, dtype=torch.int32)
    want, done = bp_decode_plain(llr, prior, return_done=True, sweeps=sp,
                                 **kw)
    off = bp_decode(llr, prior, **kw)           # untraced: nothing counted
    with tracing.enabled():
        with tracing.batch():
            with tracing.span("chain.decode"):
                on = bp_decode(llr, prior, **kw)
                on2, done2 = bp_decode(llr, prior, return_done=True, **kw)
    s = tracing.summary()
    assert s["device_counters"] == {
        "sweeps.bp": {"sum": 2 * int(sp.sum()), "items": 96},
        "converged.bp": {"sum": 2 * int(done.sum()), "items": 96}}
    assert "device counter sweeps.bp" in tracing.format_table(s)
    for x in (off, on, on2):
        assert torch.equal(_bits(x), _bits(want))
    assert torch.equal(done2, done)
    # a session in which BP runs only outside the traced block has none
    with tracing.enabled():
        with tracing.batch():
            with tracing.span("chain.decode"):
                pass
    bp_decode(llr, prior, **kw)
    assert tracing.summary()["device_counters"] == {}
    # without early stop every codeword runs every sweep, none converges
    with tracing.enabled():
        with tracing.batch():
            bp_decode(llr, prior, **_kw(5, 2, False))
    assert tracing.summary()["device_counters"] == {
        "sweeps.bp": {"sum": 5 * 48, "items": 48}}


@pytest.mark.parametrize("n,lattice,msg_dtype", [
    (1024, "auto", torch.float32), (2048, "auto", torch.bfloat16),
    (8, "auto", torch.float32), (1024, "global", torch.float32)],
    ids=["n1024_f32", "n2048_bf16", "n8_f32", "n1024_global"])
def test_launch_counters_only_in_a_traced_summary(n, lattice, msg_dtype):
    """Each launch adds ``form.bp.tiled`` (1 for the tiled schedule) and
    ``syncs.bp`` (its plan's CTA barriers a sweep) once, only while tracing
    is on; ``launch.bp`` and ``form.bp.bf16`` count on or off. The card's
    launch path (``bp_decode``) makes this call after every launch with
    the card build's plan; here the host build's, which shares its code."""
    names = ("launch.bp", "form.bp.bf16", "form.bp.tiled", "syncs.bp")
    bf16 = int(msg_dtype == torch.bfloat16)
    before = {k: tracing.counter(k) for k in names}
    cuda_bp._count_launch("host", n, 1, lattice, msg_dtype)    # untraced
    assert {k: tracing.counter(k) - before[k] for k in names} == {
        "launch.bp": 1, "form.bp.bf16": bf16, "form.bp.tiled": 0,
        "syncs.bp": 0}
    with tracing.enabled():
        with tracing.batch():
            with tracing.span("kernel.bp"):
                cuda_bp._count_launch("host", n, 1, lattice, msg_dtype)
                cuda_bp._count_launch("host", n, 0, lattice, msg_dtype)
    span = tracing.summary()["spans"]["kernel.bp"]
    tiled = int(resolve_lattice(n, lattice) == "shared")
    syncs = launch_plan(n, lattice, msg_dtype)[1]
    assert syncs == (2 * ((n.bit_length() + 1) // 3 - 1) if tiled
                     else 2 * (n.bit_length() - 1 - 5))
    got = {k: span.get(k, 0) for k in names}
    assert got == {"launch.bp": 1, "form.bp.bf16": bf16,
                   "form.bp.tiled": tiled, "syncs.bp": syncs}


def test_count_on_device_is_off_untraced_and_charges_no_span():
    x = torch.arange(10, dtype=torch.int32)
    tracing.count_on_device("test.off", x)
    assert tracing.counter("test.off") == 0
    with tracing.enabled():
        with tracing.batch():
            with tracing.span("test.span"):
                tracing.count_on_device("test.sum", x)
                tracing.count_on_device("test.sum", x[:4])
    s = tracing.summary()
    assert s["device_counters"] == {"test.sum": {"sum": 51, "items": 14}}
    assert s["spans"]["test.span"]["ops"] == 0


def test_traced_sim_ber_counts_every_codeword():
    n, k, bs, batches = 64, 32, 16, 3
    frozen, _ = generate_5g_ranking(k, n)
    model = SystemAWGNModel(n, k, PolarEncoder(frozen, n, device="cpu"),
                            PolarBPDecoder(frozen, n, device="cpu"))
    gen_off = sim_ber(model, [1.5], bs, batches, early_stop=False,
                      verbose=False, seed=11)
    with tracing.enabled():
        gen_on = sim_ber(model, [1.5], bs, batches, early_stop=False,
                         verbose=False, seed=11)
    c = tracing.summary()["device_counters"]
    assert c["sweeps.bp"]["items"] == bs * batches
    assert c["converged.bp"]["items"] == bs * batches
    assert 2 * bs * batches <= c["sweeps.bp"]["sum"] <= 20 * bs * batches
    assert all(np.array_equal(a, b) for a, b in zip(gen_off, gen_on))
