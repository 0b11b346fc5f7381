"""polar_torch's public surface against polar_tpu's: every name the JAX
package exports (its reference-compatible aliases included), the
constellation's call and plot, the mapper's symbol indices, and the SCL
decoder's ``schedule``, which resolves ``use_fast_scl`` as JAX does; and
the tests' own rule that a pytest-xdist worker gives torch its share of the
CPUs."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import polar_tpu
from polar_tpu.models.polar.hybrid import (
    HybridSCLDecoder as JHybridSCLDecoder)
from polar_tpu.models.polar.scl import PolarSCLDecoder as JPolarSCLDecoder
from polar_tpu.ops.mapping import Constellation as JConstellation
from polar_tpu.ops.mapping import Mapper as JMapper
from polar_tpu.sim import hard_decisions as j_hard_decisions

from _torch_parity import run_both, share_cpus_among_xdist_workers
import polar_torch as pt
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.hybrid import HybridSCLDecoder
from polar_torch.models.polar.scl import PolarSCLDecoder


def test_every_jax_public_name_is_exported():
    missing = [name for name in polar_tpu.__all__
               if name not in pt.__all__ or not hasattr(pt, name)]
    assert not missing, missing
    assert all(hasattr(pt, name) for name in pt.__all__)
    assert pt.__version__ == polar_tpu.__version__


@pytest.mark.parametrize("alias,target", [
    ("SC_Dec", "PolarSCDecoder"), ("SCL_Dec", "PolarSCLDecoder"),
    ("System_AWGN_model", "SystemAWGNModel"),
    ("System_BEC_model", "SystemBECModel"), ("no_encoder", "NoEncoder"),
    ("no_decoder", "NoDecoder"), ("QamConstell", "Constellation"),
])
def test_reference_aliases(alias, target):
    assert getattr(pt, alias) is getattr(pt, target)


def test_gen_arikan_and_hard_decisions_equal_jax():
    base = np.array([[1, 0], [1, 1]])
    np.testing.assert_array_equal(pt.gen_arikan(base, 4),
                                  polar_tpu.gen_arikan(base, 4))
    llr = np.random.default_rng(0).normal(0, 2, (8, 16)).astype(np.float32)
    llr[0, :3] = 0.0
    np.testing.assert_array_equal(
        *run_both(j_hard_decisions, pt.hard_decisions, llr))


@pytest.mark.parametrize("m", [2, 4, 6])
def test_mapper_indices_equal_jax(m):
    bits = np.random.default_rng(m).integers(0, 2, (5, 12 * m)).astype(
        np.float32)
    c = pt.QamConstell(m, device="cpu")
    x, idx = pt.Mapper(c, return_indices=True)(torch.from_numpy(bits))
    jx, jidx = JMapper(JConstellation(m), return_indices=True)(
        jnp.asarray(bits))
    assert idx.dtype == torch.int64 and idx.shape == (5, 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert torch.equal(pt.Mapper(c)(torch.from_numpy(bits)), x)


def test_constellation_call_and_show():
    c = pt.Constellation(4, device="cpu")
    assert c() is c.points
    np.testing.assert_array_equal(c().numpy(),
                                  np.asarray(JConstellation(4)()))
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = c.show()
    ax = fig.axes[0]
    assert len(ax.texts) == 16 and ax.texts[5].get_text() == "0101"
    plt.close(fig)


def _logits(n, bs, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (bs, n))
    return (-2.0 * ((1.0 - 2.0 * c) + rng.normal(0, 0.8, (bs, n)))
            / 0.64).astype(np.float32)


@pytest.mark.parametrize("schedule", ["scan", "unrolled"])
def test_scl_schedule_equals_jax(schedule):
    """At n = 64 each schedule resolves use_fast_scl=None as JAX does and
    decodes to JAX's decisions on the same LLRs."""
    n, k = 64, 32
    frozen, _ = generate_5g_ranking(k, n)
    logits = _logits(n, 64, 11)
    jdec = JPolarSCLDecoder(frozen, n, list_size=8, schedule=schedule)
    tdec = PolarSCLDecoder(frozen, n, list_size=8, schedule=schedule,
                           device="cpu")
    assert tdec.schedule == jdec.schedule == schedule
    assert tdec.use_fast_scl == jdec.use_fast_scl == (schedule == "unrolled")
    np.testing.assert_array_equal(*run_both(jdec, tdec, logits))


@pytest.mark.parametrize("n", [64, 256])
def test_scl_schedule_auto_and_errors(n):
    frozen, _ = generate_5g_ranking(n // 2, n)
    for schedule in ("auto", "scan", "unrolled"):
        want = JPolarSCLDecoder(frozen, n, list_size=8, schedule=schedule)
        got = PolarSCLDecoder(frozen, n, list_size=8, schedule=schedule,
                              device="cpu")
        assert (got.schedule, got.use_fast_scl) == (want.schedule,
                                                   want.use_fast_scl)
        # an explicit use_fast_scl wins over the schedule, as in JAX
        assert not PolarSCLDecoder(frozen, n, schedule=schedule,
                                   use_fast_scl=False,
                                   device="cpu").use_fast_scl
    with pytest.raises(ValueError, match="schedule"):
        PolarSCLDecoder(frozen, n, schedule="fused", device="cpu")


def test_hybrid_passes_schedule():
    n, k = 64, 40
    frozen, _ = generate_5g_ranking(k, n)
    kw = dict(list_size=8, crc_degree="CRC11", schedule="unrolled")
    want = JHybridSCLDecoder(frozen, n, **kw)
    got = HybridSCLDecoder(frozen, n, device="cpu", **kw)
    assert got.schedule == want.schedule == "unrolled"
    assert got._scl.use_fast_scl and want._scl.use_fast_scl
    via_scl = PolarSCLDecoder(frozen, n, use_hybrid_sc=True, device="cpu",
                              **kw)
    assert via_scl._hybrid._scl.use_fast_scl
    with pytest.raises(ValueError, match="schedule"):
        HybridSCLDecoder(frozen, n, device="cpu",
                         **dict(kw, schedule="fused"))


def _with_requires_host(pkg, config, **dev):
    """The object of ``config`` built from ``pkg`` (``polar_tpu`` or
    ``polar_torch``, with ``dev`` its device keyword)."""
    n, k = 64, 40
    frozen, _ = pkg.generate_5g_ranking(k, n)
    scl = dict(list_size=8, crc_degree="CRC11")
    if config == "scl":
        return pkg.PolarSCLDecoder(frozen, n, list_size=8, **dev)
    if config == "scl_hybrid":
        return pkg.PolarSCLDecoder(frozen, n, use_hybrid_sc=True, **scl,
                                   **dev)
    if config == "hybrid":
        return pkg.HybridSCLDecoder(frozen, n, **scl, **dev)
    system, dec_type = config.split("_")
    enc = pkg.Polar5GEncoder(40, 100, **dev)
    dec = pkg.Polar5GDecoder(enc, dec_type=dec_type, list_size=8)
    if system == "5g":
        return dec
    model = (pkg.SystemAWGNModel if system == "awgn" else pkg.SystemBECModel)
    return model(100, 40, enc, dec)


@pytest.mark.parametrize("config", [
    "scl", "scl_hybrid", "hybrid", "5g_SC", "5g_SCL", "5g_hybSCL",
    "awgn_SCL", "awgn_hybSCL", "bec_SC", "bec_hybSCL"])
def test_requires_host_equals_jax(config):
    want = _with_requires_host(polar_tpu, config).requires_host
    got = _with_requires_host(pt, config, device="cpu").requires_host
    assert got == want
    assert want == config.endswith(("hybrid", "hybSCL"))


@pytest.mark.parametrize("workers,threads", [("6", 1), ("2", 4), (None, None)])
def test_xdist_worker_takes_its_share_of_the_cpus(monkeypatch, workers,
                                                  threads):
    """Of ``-n workers`` on 8 CPUs, a worker gives torch and the
    subprocesses its tests start 8 // workers threads; outside xdist,
    torch's count and the environment stay as they were."""
    saved = torch.get_num_threads()
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "as before")
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    try:
        assert share_cpus_among_xdist_workers() == threads
        assert torch.get_num_threads() == (saved if threads is None
                                           else threads)
        env = "as before" if threads is None else str(threads)
        assert os.environ["OMP_NUM_THREADS"] == env
        assert os.environ["MKL_NUM_THREADS"] == env
    finally:
        torch.set_num_threads(saved)
