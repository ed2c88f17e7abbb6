from .mesh import (
    batched_engine_for_serving,
    default_mesh_shape,
    init_distributed,
    local_lm_config,
    make_mesh,
    shard_batched_engine_for_serving,
    shard_engine_for_inference,
    shard_lm_for_inference,
    shard_lm_params,
)
from .serving import ShardedBatchedEngine, follow
