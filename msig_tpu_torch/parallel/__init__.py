"""Parallelism of the port: device lists and torch.distributed data parallelism."""

from msig_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    all_reduce_mean_,
    batch_rows,
    data_mesh_for_batch,
    gather_rows,
    initialize_multihost,
    local_devices,
    local_rank,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
    world,
)
