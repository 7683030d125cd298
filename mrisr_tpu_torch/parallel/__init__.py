"""The ('data', 'model') mesh over a process group (counterpart:
``mrisr_tpu/parallel``): batch shards, replication from rank 0, the
'model' axis's parameter shardings and column-parallel forward,
process-group setup and the autograd-carrying collectives."""

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
    shard_module,
)
