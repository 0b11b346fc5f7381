"""The polar_torch Monte-Carlo harness: counters, status codes, early stop,
checkpoint and resume, JSONL metrics, seeding, uncoded QPSK against theory,
and the SC chain through ``PlotBER`` (as ``tests/test_sim.py`` holds the
JAX harness)."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)
from polar_torch import PlotBER, SystemAWGNModel, sim_ber
from polar_torch.models.polar.construction import generate_5g_ranking
from polar_torch.models.polar.encode import PolarEncoder
from polar_torch.models.polar.sc import PolarSCDecoder
from polar_torch.sim import (STATUS_LEVELS, count_block_errors,
                             count_errors, hard_decisions,
                             iteration_generator)

CPU = torch.device("cpu")


def test_count_errors_and_hard_decisions():
    a = torch.tensor([[0., 1., 1.], [0., 0., 0.]])
    b = torch.tensor([[0., 0., 1.], [1., 1., 1.]])
    assert count_errors(a, b).item() == 4
    assert count_block_errors(a, b).item() == 2
    assert count_block_errors(a, a).item() == 0
    assert count_errors(a, b).dtype == torch.int64
    np.testing.assert_array_equal(
        hard_decisions(torch.tensor([-1.0, 0.0, 2.5])).numpy(),
        [0.0, 0.0, 1.0])
    assert len(STATUS_LEVELS) == 5


class _Model:
    """``errors(ebno_db)`` bits wrong in every 8-bit block; counts its
    steps."""

    device = CPU

    def __init__(self, errors=lambda ebno_db: 0):
        self.errors = errors
        self.steps = 0

    def step(self, generator, batch_size, ebno_db):
        self.steps += 1
        b = torch.randint(0, 2, (batch_size, 8), generator=generator,
                          device=generator.device).float()
        b_hat = b.clone()
        wrong = self.errors(ebno_db)
        b_hat[:, :wrong] = 1.0 - b_hat[:, :wrong]
        return b, b_hat


def _status(tmp_path, model, ebno_dbs, name="state", **kw):
    state = str(tmp_path / f"{name}.npz")
    ber, bler = sim_ber(model, ebno_dbs, verbose=False, state_path=state,
                        **kw)
    with np.load(state) as st:
        return ber, bler, st["status"].tolist()


def test_early_stop_status_2(tmp_path):
    model = _Model()
    ber, bler, status = _status(tmp_path, model, [0.0, 1.0, 2.0],
                                batch_size=4, max_mc_iter=3)
    # the first point is error-free: early stop, the rest not simulated
    assert status == [2, 0, 0] and model.steps == 3
    assert ber.tolist() == [0.0, 0.0, 0.0] and bler.shape == (3,)


def test_max_iter_status_1_and_target_block_errors_status_4(tmp_path):
    model = _Model(lambda ebno_db: 8 if ebno_db < 1.0 else 1)
    ber, bler, status = _status(tmp_path, model, [0.0, 2.0], batch_size=10,
                                max_mc_iter=100, target_block_errs=25)
    assert status == [4, 4] and model.steps == 6
    assert ber[0] == 1.0 and bler[0] == 1.0 and ber[1] == 1 / 8
    ber, bler, status = _status(tmp_path, _Model(lambda e: 1), [0.0],
                                name="max_iter", batch_size=10,
                                max_mc_iter=3, target_block_errs=1000)
    assert status == [1] and bler[0] == 1.0


def test_target_bit_errors_status_3(tmp_path):
    _, _, status = _status(tmp_path, _Model(lambda e: 2), [0.0],
                           batch_size=5, max_mc_iter=50,
                           target_bit_errs=30)
    assert status == [3]


class _Interrupted(Exception):
    pass


def test_resume_equals_uninterrupted_run(tmp_path):
    k, n = 16, 32
    frozen, _ = generate_5g_ranking(k, n)
    model = SystemAWGNModel(n, k, PolarEncoder(frozen, n, device="cpu"),
                            PolarSCDecoder(frozen, n, device="cpu"))
    ebno = [0.0, 1.0, 2.0]
    kw = dict(batch_size=64, max_mc_iter=2, verbose=False, seed=5,
              early_stop=False)
    want = sim_ber(model, ebno, **kw)

    class Failing:
        device = CPU

        def step(self, generator, batch_size, ebno_db):
            if ebno_db == 2.0:
                raise _Interrupted
            return model.step(generator, batch_size, ebno_db)

    state = str(tmp_path / "state.npz")
    jsonl = str(tmp_path / "metrics.jsonl")
    with pytest.raises(_Interrupted):
        sim_ber(Failing(), ebno, state_path=state, jsonl_path=jsonl, **kw)
    with np.load(state) as st:
        assert int(st["next_point"]) == 2
    got = sim_ber(model, ebno, state_path=state, jsonl_path=jsonl, **kw)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    lines = [json.loads(line) for line in open(jsonl)]
    assert [line["ebno_db"] for line in lines] == ebno
    assert set(lines[0]) == {"ebno_db", "bit_errors", "num_bits",
                             "block_errors", "num_blocks", "runtime_s",
                             "status"}
    assert all(line["num_blocks"] == 128 and line["status"] == 1
               for line in lines)


def test_same_seed_reproduces_and_seeds_differ():
    k, n = 16, 32
    frozen, _ = generate_5g_ranking(k, n)
    model = SystemAWGNModel(n, k, PolarEncoder(frozen, n, device="cpu"),
                            PolarSCDecoder(frozen, n, device="cpu"))
    kw = dict(batch_size=64, max_mc_iter=3, verbose=False)
    r1 = sim_ber(model, [1.0], seed=7, **kw)
    r2 = sim_ber(model, [1.0], seed=7, **kw)
    r3 = sim_ber(model, [1.0], seed=8, **kw)
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_array_equal(r1[1], r2[1])
    assert r1[0][0] != r3[0][0]
    g1, g2 = (iteration_generator(7, 1, 2, CPU) for _ in range(2))
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))
    assert not torch.equal(
        torch.rand(4, generator=iteration_generator(7, 2, 1, CPU)),
        torch.rand(4, generator=iteration_generator(7, 1, 2, CPU)))


class _Identity:
    """Uncoded link: k = n, the bits go out as they come in."""
    device = CPU

    def __call__(self, x):
        return x


class _HardIdentity:
    """Hard decisions on the demapper's logits."""

    def __call__(self, llr):
        return hard_decisions(llr)


def test_uncoded_qpsk_ber_matches_theory():
    from scipy.stats import norm
    n, ebno_db = 128, 4.0
    model = SystemAWGNModel(n, n, _Identity(), _HardIdentity())
    ber, _ = sim_ber(model, [ebno_db], batch_size=2000, max_mc_iter=10,
                     early_stop=False, verbose=False)
    want = norm.sf(np.sqrt(2 * 10 ** (ebno_db / 10)))
    assert abs(ber[0] - want) / want < 0.05


def test_sharded_counters_raise():
    """A model with its own reduced counters (``parallel.ShardedSystem``)
    feeds ``sim_ber`` through ``counted_step``, which raises nothing now:
    the sweep takes the counters as they are, targets and early stop
    included."""
    class Sharded:
        device = CPU

        def __init__(self):
            self.calls = []

        def counted_step(self, generator, batch_size, ebno_db):
            self.calls.append((generator.device, batch_size, ebno_db))
            return (3, 1, 8 * batch_size, batch_size) if ebno_db < 1.0 \
                else (0, 0, 8 * batch_size, batch_size)

    model = Sharded()
    ber, bler = sim_ber(model, [0.0, 2.0, 4.0], batch_size=4, max_mc_iter=3,
                        target_block_errs=2, verbose=False)
    np.testing.assert_array_equal(ber, [6 / 64, 0.0, 0.0])
    np.testing.assert_array_equal(bler, [2 / 8, 0.0, 0.0])
    assert model.calls == [(CPU, 4, 0.0)] * 2 + [(CPU, 4, 2.0)] * 3


def test_plot_ber_sc_chain(capsys):
    k, n = 32, 64
    frozen, _ = generate_5g_ranking(k, n)
    model = SystemAWGNModel(n, k, PolarEncoder(frozen, n, device="cpu"),
                            PolarSCDecoder(frozen, n, device="cpu"))
    plot = PlotBER("SC")
    ebno = np.array([1.0, 6.0, 7.0])
    ber, bler = plot.simulate(model, ebno, batch_size=200, legend="SC",
                              add_bler=True, max_mc_iter=2)
    out = capsys.readouterr().out
    assert "EbNo [dB]" in out and "no error occurred @ EbNo = 6.0" in out
    assert plot.legend == ["SC", "SC (BLER)"]
    assert 0 < ber[0] < bler[0] < 1 and ber[1] == 0 and ber[2] == 0
    import matplotlib.pyplot as plt
    fig, _ = plot.plot(ylabel="BLER")
    fig.savefig(os.devnull, format="png")
    plt.close(fig)
