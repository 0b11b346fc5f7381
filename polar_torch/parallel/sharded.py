"""Sharded Monte-Carlo stepping: every rank runs its shard of the batch
through the whole link chain, and one ``all_reduce`` sums the counters."""

import torch
import torch.distributed as dist

from polar_torch.parallel.mesh import make_mesh
from polar_torch.sim import (count_block_errors, count_errors, fold_in,
                             hard_decisions)


class ShardedSystem:
    """Data-parallel wrapper around a system model with a
    ``step(generator, batch_size, ebno_db)`` method.

    ``counted_step(generator, batch_size, ebno_db) -> (bit_errors,
    block_errors, nb_bits, nb_blocks)`` returns counters already summed
    over the mesh, the contract ``sim_ber`` consumes. Each rank runs
    ``batch_size / num_shards`` blocks on the model's device with the
    generator ``fold_in(generator, shard)``, so a run is reproducible for a
    fixed seed and shard count, and only the reduced counters reach the
    host."""

    def __init__(self, model, mesh=None, axis_name: str = "mc",
                 soft_estimates: bool = False):
        if not hasattr(model, "step"):
            raise TypeError("ShardedSystem needs a model with a "
                            "step(generator, batch_size, ebno_db) method")
        self.model = model
        self.device = model.device
        self.mesh = (mesh if mesh is not None
                     else make_mesh(axis_name=axis_name, device=self.device))
        self.soft_estimates = bool(soft_estimates)
        self.num_shards = self.mesh.size()
        self.shard = self.mesh.get_local_rank()     # the mesh position
        self._group = self.mesh.get_group()

    def counted_step(self, generator, batch_size: int, ebno_db):
        if batch_size % self.num_shards:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"over {self.num_shards} shards")
        b, b_hat = self.model.step(fold_in(generator, self.shard),
                                   batch_size // self.num_shards, ebno_db)
        if self.soft_estimates:
            b_hat = hard_decisions(b_hat)
        counts = torch.stack([count_errors(b, b_hat),
                              count_block_errors(b, b_hat)])
        dist.all_reduce(counts, group=self._group)
        bit_e, blk_e = counts.tolist()
        blocks = b.numel() // b.shape[-1]
        return (bit_e, blk_e, b.numel() * self.num_shards,
                blocks * self.num_shards)
