"""Data parallelism over a process group (counterpart:
``mrisr_tpu/parallel``): the data mesh, batch shards, replication from
rank 0, process-group setup and the autograd-carrying collectives."""

from mrisr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    all_gather_batch,
    average_gradients,
    batch_sharding,
    distributed_init,
    make_mesh,
    param_shardings,
    psum_mean,
    replicated,
    shard_batch,
)
