"""Device mesh construction for data-parallel Monte-Carlo simulation."""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from polar_torch._device import resolve_device


def make_mesh(num_devices: int = 0, axis_name: str = "mc",
              device=None) -> DeviceMesh:
    """1-D mesh over the ranks of the process group, one rank per device
    (``num_devices`` 0 means all of them); ``device`` gives its device
    type (the card unless the caller asks for the CPU).

    The Monte-Carlo batch axis is sharded over this mesh; a codeword stays
    on one device. Each rank drives one device, so the mesh spans the
    whole process group: ``num_devices`` is 0 or the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "polar_torch.parallel.initialize first")
    world = dist.get_world_size()
    if num_devices not in (0, world):
        raise ValueError(f"one rank per device: the mesh spans the "
                         f"{world} ranks of the process group, not "
                         f"{num_devices}")
    return DeviceMesh(resolve_device(device).type, torch.arange(world),
                      mesh_dim_names=(axis_name,))
