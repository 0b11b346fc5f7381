"""Data-parallel Monte-Carlo simulation of polar_torch on torch.distributed
(``polar_torch.parallel``), as ``tests/test_multihost.py`` holds the JAX
package's.

Two gloo processes on the CPU, started from this file (``python
tests/test_torch_parallel.py <rank> <world> <port>`` runs one), drive
``ShardedSystem`` over their mesh. The reduced counters must agree on both
ranks and equal the sum of the two shards run in one process, each with
its ``fold_in`` generator; the ``sim_ber`` sweeps of both ranks must equal
that of the same shards summed in one process."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch's threads under xdist)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
N, K, BATCH, EBNO_DB, SEED = 32, 16, 64, 2.0, 7
SWEEP = dict(ebno_dbs=[0.0, 2.0, 6.0, 8.0], batch_size=BATCH,
             max_mc_iter=8, target_block_errs=20, verbose=False, seed=11)
WORKER_TIMEOUT_S = 120


def _model():
    from polar_torch import SystemAWGNModel
    from polar_torch.models.polar.construction import generate_5g_ranking
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.models.polar.sc import PolarSCDecoder
    frozen, _ = generate_5g_ranking(K, N)
    return SystemAWGNModel(N, K, PolarEncoder(frozen, N, device="cpu"),
                           PolarSCDecoder(frozen, N, device="cpu"))


def _generator():
    return torch.Generator(device="cpu").manual_seed(SEED)


class _ShardsInOneProcess:
    """The ``counted_step`` of ``world`` shards, run one after another in
    this process with their ``fold_in`` generators and summed."""

    device = torch.device("cpu")

    def __init__(self, model, world):
        self.model, self.world = model, world

    def counted_step(self, generator, batch_size, ebno_db):
        from polar_torch.sim import (count_block_errors, count_errors,
                                     fold_in)
        out = np.zeros(4, dtype=np.int64)
        for shard in range(self.world):
            b, b_hat = self.model.step(fold_in(generator, shard),
                                       batch_size // self.world, ebno_db)
            out += [count_errors(b, b_hat).item(),
                    count_block_errors(b, b_hat).item(), b.numel(),
                    b.shape[0]]
        return tuple(int(x) for x in out)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int):
    """One rank: the sharded step and the sharded sweep, as a JSON line."""
    import torch.distributed as dist
    from polar_torch import sim_ber
    from polar_torch.parallel import (ShardedSystem, initialize,
                                      is_main_process, make_mesh)
    got = initialize(f"tcp://localhost:{port}", world_size=world, rank=rank,
                     device="cpu", timeout_s=60)
    try:
        sharded = ShardedSystem(_model(), mesh=make_mesh(device="cpu"))
        counts = sharded.counted_step(_generator(), BATCH, EBNO_DB)
        ber, bler = sim_ber(sharded, **SWEEP)
        print(json.dumps({
            "initialize": list(got), "main": is_main_process(),
            "shards": sharded.num_shards, "shard": sharded.shard,
            "counts": list(counts), "ber": ber.tolist(),
            "bler": bler.tolist()}), flush=True)
    finally:
        dist.destroy_process_group()


def _run_workers(world):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, HERE, str(r), str(world),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_gloo_processes_equal_the_shards_summed_in_one_process():
    from polar_torch import sim_ber
    outs = _run_workers(2)
    assert [o["initialize"] for o in outs] == [[0, 2, 2], [1, 2, 2]]
    assert [o["main"] for o in outs] == [True, False]
    assert [(o["shards"], o["shard"]) for o in outs] == [(2, 0), (2, 1)]
    assert outs[0]["counts"] == outs[1]["counts"]
    one = _ShardsInOneProcess(_model(), 2)
    want = one.counted_step(_generator(), BATCH, EBNO_DB)
    assert tuple(outs[0]["counts"]) == want
    assert want[2:] == (BATCH * K, BATCH) and want[1] > 0
    # the sweep: both ranks and the one-process shards alike, point by
    # point (target errors, early stop and all)
    ber, bler = sim_ber(one, **SWEEP)
    for o in outs:
        np.testing.assert_array_equal(o["ber"], ber)
        np.testing.assert_array_equal(o["bler"], bler)
    assert bler[0] > 0 and bler[-1] == 0


def test_sharded_sweep_is_reproducible():
    """The same seed and shard count give the same sweep; another seed or
    shard count gives another stream."""
    from polar_torch import sim_ber
    from polar_torch.sim import fold_in
    model = _model()
    runs = [sim_ber(_ShardsInOneProcess(model, w), **dict(SWEEP, seed=s))
            for w, s in ((2, 11), (2, 11), (4, 11), (2, 12))]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][0], runs[2][0])
    assert not np.array_equal(runs[0][0], runs[3][0])
    g = _generator()
    x = [torch.rand(4, generator=fold_in(g, i)) for i in (0, 0, 1)]
    assert torch.equal(x[0], x[1]) and not torch.equal(x[0], x[2])


def test_sharded_system_needs_a_process_group_and_a_step():
    from polar_torch.parallel import ShardedSystem, is_main_process, \
        make_mesh
    assert is_main_process()                 # no process group: rank 0
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    with pytest.raises(TypeError, match="step"):
        ShardedSystem(object(), mesh=object())


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(*(int(x) for x in sys.argv[1:4]))
