"""Data-parallel Monte-Carlo over every card of the host, with
``polar_torch`` (the PyTorch and CUDA port).

One process per rank, started by ``torch.multiprocessing``: each rank runs
its shard of every batch through the whole chain on its own card (SCL-8 on
the plain sweep, one ``scl_subtree`` kernel call per decode at n=256) with
a generator derived from the shared one and its rank, and one
``all_reduce`` sums the error counters, so every rank takes the same
early-stop branch. Rank 0 prints the summed BER and BLER.

On the card the ranks join an NCCL group, one per card
(``torch.cuda.device_count()`` unless ``--world`` says otherwise):

    python examples/torch_03_multichip.py

Anywhere, on the CPU, with N gloo processes:

    python examples/torch_03_multichip.py --device cpu --world 2

Across hosts, start one process per device on each host and give every
one the same store address, the world size and its own rank
(``polar_torch.parallel.initialize("tcp://host0:29500", world, rank)``).
"""

import os
import sys

# runnable without installation: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import polar_torch as pt
from polar_torch.parallel import (ShardedSystem, initialize, is_main_process,
                                  make_mesh)
from polar_torch.utils.kernel_work import launch_counts


def run(rank, world, port, args):
    """One rank: join the group, shard the sweep, print on rank 0."""
    device = "cpu" if args.device == "cpu" else None
    if device == "cpu":     # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(f"tcp://localhost:{port}", world, rank, device=device)
    try:
        k, n = 128, 256
        frozen, _ = pt.generate_5g_ranking(k, n)
        enc = pt.PolarEncoder(frozen, n, device=device)  # this rank's card
        model = pt.SystemAWGNModel(
            n, k, enc, pt.PolarSCLDecoder(frozen, n, list_size=8,
                                          device=enc.device))
        sharded = ShardedSystem(model, make_mesh(device=enc.device))
        ber, bler = pt.sim_ber(sharded, [1.0, 2.0, 3.0],
                               batch_size=args.batch_size,
                               max_mc_iter=args.max_mc_iter,
                               target_block_errs=200,
                               verbose=is_main_process())
        if is_main_process():
            print(f"world of {world} ({dist.get_backend()}), rank 0 on "
                  f"{enc.device}")
            print("BER :", ber)
            print("BLER:", bler)
            print(f"kernel launches (rank 0): {json.dumps(launch_counts())}")
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; 2 on the CPU)")
    ap.add_argument("--batch-size", type=int, default=4096,
                    help="the whole batch, split over the ranks")
    ap.add_argument("--max-mc-iter", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    mp.spawn(run, args=(world, free_port(), args), nprocs=world, join=True)


if __name__ == "__main__":
    main()
