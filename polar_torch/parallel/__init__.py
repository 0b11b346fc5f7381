"""Data parallelism for the Monte-Carlo harness on ``torch.distributed``.

The counterpart of the JAX package's ``polar_tpu.parallel``. The
Monte-Carlo batch is embarrassingly parallel, so the design is pure data
parallelism over a 1-D ``DeviceMesh``, one process (rank) per device:

* each rank runs its shard of the batch on its own device, with a
  generator derived from the shared one and its mesh position (``fold_in``),
  so a run is reproducible for a fixed seed and shard count;
* the error counters are summed with one ``all_reduce`` on the device, so
  only the reduced counters reach the host, and every rank takes the same
  early-stop branch in ``sim_ber``.
"""

from polar_torch.parallel.mesh import make_mesh
from polar_torch.parallel.multihost import initialize, is_main_process
from polar_torch.parallel.sharded import ShardedSystem

__all__ = ["make_mesh", "ShardedSystem", "initialize", "is_main_process"]
