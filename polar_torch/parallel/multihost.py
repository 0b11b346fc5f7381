"""Multi-process setup: one process per device, on one host or many.

Monte-Carlo FEC simulation is pure data parallelism, so a run needs only
a process group (``initialize``), a mesh over its ranks (``make_mesh``) and
counters reduced across it (``ShardedSystem``). Counter checkpointing for
long sweeps lives in ``sim.sim_ber`` (``state_path``): on restart the
counters resume whatever the new process layout, since the persistent
state is a handful of host integers.
"""

import datetime

import torch
import torch.distributed as dist

from polar_torch._device import resolve_device


def initialize(init_method: str = None, world_size: int = None,
               rank: int = None, device=None, timeout_s: float = 300.0):
    """Join the process group (``torch.distributed.init_process_group``):
    NCCL on the card, gloo on the CPU (``device="cpu"``). ``init_method``
    is the store's address, as ``"tcp://localhost:<port>"``; with None the
    address, world size and rank come from the environment (``env://``).
    On the card each rank takes the card ``rank % device_count``.

    Returns ``(rank, world_size, global device count)``, the last equal to
    the world size: one device per rank."""
    dev = resolve_device(device)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size(), dist.get_world_size()


def is_main_process() -> bool:
    """True on the process that should own logging, plots and checkpoints
    (rank 0, or a run without a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0
