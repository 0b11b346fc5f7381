"""The profiling tools of polar_torch against polar_tpu's: ``flop_estimate``
counts as XLA's cost analysis does (the JAX package's ``flop_estimate`` on
JAX-CPU), ``trace`` writes a profiler trace, and the hand-written kernels'
work counts (``kernel_work``) reach a running estimate."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from polar_tpu.utils.profiling import flop_estimate as j_flop_estimate

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.models.polar.scan_core import fast_schedule
from polar_torch.utils import kernel_work
from polar_torch.utils.profiling import flop_estimate, trace

FUNCTIONS = {
    "dot": (lambda x: jnp.dot(x, x), lambda x: x @ x),
    "tanh_plus_x": (lambda x: jnp.tanh(x) + x, lambda x: torch.tanh(x) + x),
    "where": (lambda x: jnp.where(x > 0, x, 0.0),
              lambda x: torch.where(x > 0, x, 0.0)),
    "sum": (lambda x: x.sum(axis=0), lambda x: x.sum(dim=0)),
    "matvec": (lambda x: x @ x[0], lambda x: x @ x[0]),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_flop_estimate_equals_jax(name):
    """2 M N K per product, one per output element of an arithmetic op
    (a select and a compare included), none for a transcendental: dot of
    64x64 is 524288 and tanh(x) + x 4096, as the JAX package counts."""
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    j_fn, t_fn = FUNCTIONS[name]
    want = j_flop_estimate(j_fn, jnp.asarray(x))
    got = flop_estimate(t_fn, torch.from_numpy(x))
    assert got == want
    if name in ("dot", "tanh_plus_x"):
        assert got == {"dot": 524288.0, "tanh_plus_x": 4096.0}[name]


def test_kernel_work_reaches_a_running_estimate():
    """A kernel wrapper's ``report`` adds its launch's f32 operations to
    every running estimate and does nothing without one."""
    frozen, _ = generate_5g_ranking(16, 32)
    mask = np.zeros(32, bool)
    mask[frozen] = True
    ops = fast_schedule(mask, rep=False)
    work = kernel_work.sc_subtree_work(ops, 5, 100, "minsum")
    kernel_work.report(kernel_work.sc_subtree_work, ops, 5, 100, "minsum")

    def launch():
        kernel_work.report(kernel_work.sc_subtree_work, ops, 5, 100,
                           "minsum")

    assert flop_estimate(launch) == work[1] > 0
    assert flop_estimate(lambda: flop_estimate(launch)) == work[1]
    assert not kernel_work._estimates


def test_work_counts_of_small_schedules():
    """Hand counts: the SC decode of a 2-leaf info subtree (one f, one g,
    one xor per codeword); a PC leaf costs an SCL path one softplus, as a
    frozen one, and no fork."""
    n_bytes, n_ops = kernel_work.sc_subtree_work(
        [("i", 0, 0), ("i", 0, 1)], 1, 10, "minsum")
    assert n_bytes == 4 * 2 * 10 * 2 + 12 * 2
    assert n_ops == 10 * (kernel_work.OPS_F["minsum"] + kernel_work.OPS_G
                          + kernel_work.OPS_XOR)
    a = torch.zeros(2, 4, 10)
    frozen = kernel_work.subtree_work([("i", 0, 0), ("f", 0, 1)], 1,
                                      "minsum", a)
    pc = kernel_work.subtree_work([("i", 0, 0), ("p", 0, 1)], 1, "minsum",
                                  a)
    assert pc == frozen
    assert kernel_work.bp_work(64, 2, 2 * 20, 0, "minsum", 1.0)[1] == 40 * (
        2 * 6 * 32 * (2 * kernel_work.OPS_F["minsum"] + 2))


def test_flop_estimate_counts_the_plain_decode_on_the_cpu():
    """On the CPU a decode runs the kernels' plain versions, whose aten
    ops the estimate counts; the result is the same decode."""
    frozen, _ = generate_5g_ranking(16, 32)
    dec = PolarSCDecoder(frozen, 32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 32)).astype(np.float32))
    out = {}
    flops = flop_estimate(lambda v: out.setdefault("u", dec(v)), x)
    assert flops > 0 and torch.equal(out["u"], dec(x))


def test_trace_writes_its_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.ones(64, 64)
    with trace(log_dir) as prof:
        (x @ x).sum()
    assert prof is not None
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
