"""The QPSK transmitter (``cuda_front``): the host build of the kernel's
routines and the plain version against the composed chain of
``SystemAWGNModel`` on the same generator (codewords and LLRs bit for bit,
the generator left where the chain leaves it), the rule that says which
chains take the kernel, and the wrapper's checks and CPU route."""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar import cuda_front
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.cuda_front import (
    qpsk_amplitude, qpsk_front, qpsk_front_host, qpsk_front_plain,
    transmit_plan)
from polar_torch.models.polar.dense import DenseKernelEncoder
from polar_torch.models.polar.encode import Polar5GEncoder, PolarEncoder
from polar_torch.models.systems import SystemAWGNModel
from polar_torch.ops.channels import normal_parts
from polar_torch.ops.ebno import ebnodb2no
from polar_torch.ops.mapping import Constellation
from polar_torch.ops.source import binary_source
from polar_torch.utils import kernel_work, tracing


def _bits_of(x):
    """The f32 bits, so +0 and -0 (and every NaN) count as different."""
    return x.contiguous().view(torch.int32)


def _code(n, seed):
    """A random frozen set of a random k in 1..n."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, n + 1))
    return np.sort(rng.choice(n, n - k, replace=False)), k


def _composed_and_draws(n, bs, seed, ebno_db):
    """The composed chain's ``(bits, codewords, llr)`` and generator, and
    the same seed's draws as the kernel path makes them, with its
    generator."""
    frozen, k = _code(n, seed)
    enc = PolarEncoder(frozen, n, device="cpu")
    model = SystemAWGNModel(n, k, enc, None)
    gen = torch.Generator().manual_seed(seed)
    want = model.front(gen, bs, ebno_db)
    gen2 = torch.Generator().manual_seed(seed)
    bits = binary_source(gen2, (bs, k))
    xr, xi = normal_parts(gen2, (bs, n // 2))
    args = (bits, xr, xi, enc.transmit_table(),
            qpsk_amplitude(model.constell),
            ebnodb2no(ebno_db, 2, k / n))
    return want, gen, args, gen2


@pytest.mark.parametrize("ebno_db", [-1.5, 2.0])
@pytest.mark.parametrize("bs", [1, 37])
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 1024, 2048, 4096])
def test_host_build_equals_composed_chain(n, bs, ebno_db):
    """Random frozen sets with k in 1..n; one codeword, and a ragged batch
    that fills no tile of the card's warps."""
    seed = n * 1000 + bs * 10 + int(ebno_db > 0)
    want, gen, args, gen2 = _composed_and_draws(n, bs, seed, ebno_db)
    assert torch.equal(args[0], want[0])
    for route in (qpsk_front_host, qpsk_front_plain):
        cw, llr = route(*args)
        assert cw.shape == llr.shape == (bs, n)
        assert cw.dtype == llr.dtype == torch.float32
        assert torch.equal(_bits_of(cw), _bits_of(want[1])), route.__name__
        assert torch.equal(_bits_of(llr), _bits_of(want[2])), route.__name__
    # the kernel path's draws leave the generator where the chain does
    assert torch.equal(gen.get_state(), gen2.get_state())


@pytest.mark.parametrize("n,k", [(64, 64), (64, 1), (1024, 512)])
def test_host_build_on_extreme_and_5g_codes(n, k):
    """Every position an info bit, one info bit, and the benchmark's
    5G-ranked (1024, 512) code."""
    frozen = (generate_5g_ranking(k, n)[0] if n == 1024
              else np.setdiff1d(np.arange(n), np.arange(k)))
    enc = PolarEncoder(frozen, n, device="cpu")
    model = SystemAWGNModel(n, k, enc, None)
    gen = torch.Generator().manual_seed(n + k)
    bits, want_cw, want_llr = model.front(gen, 67, 1.0)
    gen = torch.Generator().manual_seed(n + k)
    binary_source(gen, (67, k))
    xr, xi = normal_parts(gen, (67, n // 2))
    cw, llr = qpsk_front_host(bits, xr, xi, enc.transmit_table(),
                              qpsk_amplitude(model.constell),
                              ebnodb2no(1.0, 2, k / n))
    assert torch.equal(_bits_of(cw), _bits_of(want_cw))
    assert torch.equal(_bits_of(llr), _bits_of(want_llr))


def test_wrapper_runs_plain_version_on_cpu():
    want, _, args, _ = _composed_and_draws(256, 9, 5, 2.0)
    before = tracing.counter("launch.qpsk_front")
    cw, llr = qpsk_front(*args)
    assert tracing.counter("launch.qpsk_front") == before
    assert torch.equal(_bits_of(cw), _bits_of(want[1]))
    assert torch.equal(_bits_of(llr), _bits_of(want[2]))


def _encoder(case):
    frozen, _ = generate_5g_ranking(512, 1024)
    if case == "5g":
        return Polar5GEncoder(400, 1000, device="cpu")
    if case == "dense":
        return DenseKernelEncoder(frozen, 1024, device="cpu")
    if case == "bf16":
        return PolarEncoder(frozen, 1024, dtype=torch.bfloat16, device="cpu")
    if case == "n8192":
        return PolarEncoder(np.arange(4096), 8192, device="cpu")
    if case in ("n2", "n4096"):
        n = int(case[1:])
        return PolarEncoder(np.arange(n // 2), n, device="cpu")
    return PolarEncoder(frozen, 1024, device="cpu")


@pytest.mark.parametrize("case,bits_per_sym,device,takes", [
    ("plain", 2, "cuda", True), ("n2", 2, "cuda", True),
    ("n4096", 2, "cuda", True), ("plain", 2, "cuda:1", True),
    ("plain", 2, "cpu", False), ("5g", 2, "cuda", False),
    ("dense", 2, "cuda", False), ("plain", 4, "cuda", False),
    ("plain", 6, "cuda", False), ("bf16", 2, "cuda", False),
    ("n8192", 2, "cuda", False)])
def test_transmit_plan_takes_the_kernel_only_for_plain_qpsk_on_a_card(
        case, bits_per_sym, device, takes):
    """The rule is a function of types and shapes: a ``PolarEncoder`` in
    f32 with 2 <= n <= 4096, the normalised Gray QPSK, a card. No card is
    needed to ask it."""
    enc = _encoder(case)
    plan = transmit_plan(enc, Constellation(bits_per_sym, device="cpu"),
                         device)
    assert (plan is not None) == takes
    if takes:
        table, a = plan
        assert table.dtype == torch.int16 and table.shape == (enc.n,)
        assert torch.equal(table.long(), enc._scatter_idx)
        qpsk = Constellation(2, device="cpu")
        assert a == float(qpsk.points_np[0].real)


def test_qpsk_amplitude_reads_the_mapper_points():
    """0.70710683, one ulp above the f32 of 1/sqrt(2), as the normalised
    constellation holds it; none for the points in another label order,
    nor for 16-QAM."""
    c = Constellation(2, device="cpu")
    a = qpsk_amplitude(c)
    assert a == float(c.points_np[0].real) == float(np.float32(0.70710683))
    assert a != float(np.float32(1 / np.sqrt(2)))
    c.points_np = c.points_np[[1, 0, 3, 2]]
    assert qpsk_amplitude(c) is None
    assert qpsk_amplitude(Constellation(4, device="cpu")) is None


def test_the_cpu_model_keeps_the_composed_chain():
    frozen, _ = generate_5g_ranking(32, 64)
    model = SystemAWGNModel(64, 32, PolarEncoder(frozen, 64, device="cpu"),
                            None)
    assert model._transmit is None
    with tracing.enabled():
        with tracing.batch():
            with tracing.span("chain.front"):
                model.front(torch.Generator().manual_seed(1), 4, 1.0)
    names = {r[0] for r in tracing.records()}
    assert {"front.encode", "front.map", "front.channel",
            "front.demap"} <= names
    assert not {"front.transmit", "kernel.qpsk_front"} & names


def _inputs(n=64, bs=5, k=32):
    frozen = np.arange(n - k)
    enc = PolarEncoder(frozen, n, device="cpu")
    gen = torch.Generator().manual_seed(3)
    return dict(bits=binary_source(gen, (bs, k)),
                xr=torch.randn((bs, n // 2), generator=gen),
                xi=torch.randn((bs, n // 2), generator=gen),
                table=enc.transmit_table())


@pytest.mark.parametrize("case,error", [
    ("bits_f64", TypeError), ("xr_f16", TypeError), ("table_i32", TypeError),
    ("table_2d", TypeError), ("n_odd", ValueError), ("n8192", ValueError),
    ("bits_1d", ValueError), ("xr_short", ValueError),
    ("xi_shape", ValueError), ("devices", ValueError),
    ("stride", ValueError), ("unaligned", ValueError)])
def test_wrapper_rejects_bad_inputs(case, error):
    x = _inputs()
    bs = x["bits"].shape[0]
    bad = {
        "bits_f64": lambda: dict(bits=x["bits"].double()),
        "xr_f16": lambda: dict(xr=x["xr"].half()),
        "table_i32": lambda: dict(table=x["table"].int()),
        "table_2d": lambda: dict(table=x["table"][None]),
        "n_odd": lambda: dict(table=x["table"][:48]),
        "n8192": lambda: dict(table=torch.zeros(8192, dtype=torch.int16)),
        "bits_1d": lambda: dict(bits=x["bits"][0]),
        "xr_short": lambda: dict(xr=x["xr"][:, :16]),
        "xi_shape": lambda: dict(xi=x["xi"][:-1]),
        "devices": lambda: dict(table=x["table"].to("meta")),
        "stride": lambda: dict(xr=torch.randn(32, bs).t()),
        "unaligned": lambda: dict(xr=torch.randn(bs * 32 + 1)[1:].view(
            bs, 32)),
    }[case]()
    args = dict(x, **bad)
    for route in (qpsk_front, qpsk_front_host):
        with pytest.raises(error):
            route(args["bits"], args["xr"], args["xi"], args["table"],
                  0.70710683, 0.5)


def test_host_build_takes_cpu_tensors_only():
    x = _inputs()
    meta = {k: v.to("meta") for k, v in x.items()}
    with pytest.raises(ValueError):
        qpsk_front_host(meta["bits"], meta["xr"], meta["xi"], meta["table"],
                        0.70710683, 0.5)


def test_transmit_scalars_take_one_variance():
    s2, sqrt_no, scale = cuda_front.transmit_scalars(0.5)
    assert s2.dtype == sqrt_no.dtype == scale.dtype == torch.float32
    assert float(sqrt_no) == float(torch.tensor(0.5).sqrt())
    with pytest.raises(ValueError):
        cuda_front.transmit_scalars(torch.tensor([0.5, 0.25]))


@pytest.mark.parametrize("bs,k,n", [(65536, 512, 1024), (8192, 512, 1024),
                                    (65536, 19, 256)])
def test_work_counts_the_bytes_once(bs, k, n):
    """4 k + 12 n bytes a codeword and the table; at (65536, 512, 1024)
    939.5 MB, 0.2805 ms at 3.35 TB/s."""
    n_bytes, n_ops = kernel_work.qpsk_front_work(bs, k, n)
    assert n_bytes == bs * (4 * k + 12 * n) + 2 * n
    assert n_ops == bs * ((n // 2) * (n.bit_length() - 1) + 4 * n)
    ms, kind = kernel_work.bound_ms(n_bytes, n_ops)
    assert kind == "bytes"
    if (bs, k, n) == (65536, 512, 1024):
        assert round(n_bytes / 1e6, 1) == 939.5
        assert round(ms, 4) == 0.2805
