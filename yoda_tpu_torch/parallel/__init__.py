"""The node-sharded fleet evaluation (counterpart of yoda_tpu/parallel).

The fleet's rows are split into contiguous blocks over a list of torch
devices (the port's mesh), driven from one process as the reference's
single controller drives its jax mesh. Each evaluation runs the hand
kernel's shard entry three times per shard (one launch per phase and 128
requests), and small torch ops combine the shards' partials in between:
the cross-shard reductions XLA inserts as collectives in the reference.
``SchedulerConfig(mesh_devices=N)`` makes the batch plugin hold a
:class:`ShardedDeviceFleetKernel` over the first N cards (or N host shards
under ``kernel_platform: cpu``).
"""

from yoda_tpu_torch.parallel.sharded import (
    ShardedDeviceFleetKernel,
    ShardedFleetKernel,
    default_mesh,
    sharded_filter_score,
)

__all__ = [
    "ShardedDeviceFleetKernel",
    "ShardedFleetKernel",
    "default_mesh",
    "sharded_filter_score",
]
