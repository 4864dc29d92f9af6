"""Multi-device parallelism over ``torch.distributed``: the process group, the
grid's split by host and the out-of-band barrier (``multihost``), and the
meshes, sharded training step, K-sharded planner and grid-sharded episodes
(``sharding``)."""

from .multihost import (  # noqa: F401
    barrier,
    global_mesh,
    host_count,
    host_index,
    host_ranks,
    initialize,
    process_count,
    process_index,
    process_slice,
)
from .sharding import (  # noqa: F401
    Mesh,
    derive_param_pspecs,
    make_grid_sharded_episodes,
    make_k_sharded_mppi_command,
    make_mesh,
    make_sharded_train_step,
    nl_param_pspecs,
    shard_params,
    unshard_params,
)
