"""Process-group parallelism of the port (the counterpart of
``graphdyn/parallel``): meshes over ``torch.distributed`` ranks, node-axis
sharding by a full gather or by the halo exchange, and the sharded SA
solver. The sharded out-of-core stream (``parallel/stream.py``) comes with
ROADMAP.md A15b."""

from graphdyn_torch.parallel.mesh import (  # noqa: F401
    device_pool,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from graphdyn_torch.parallel.halo import (  # noqa: F401
    HaloProgram,
    HaloTables,
    build_halo_tables,
    halo_rollout,
    make_halo_rollout,
)
from graphdyn_torch.parallel.sa_sharded import (  # noqa: F401
    make_sharded_sa_solver,
    sa_sharded,
)

#: the JAX package's name for the process-group bring-up
init_multihost = init_distributed
