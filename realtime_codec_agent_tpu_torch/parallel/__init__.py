from .mesh import (
    Mesh,
    Shards,
    batch_spec,
    batched_engine_for_serving,
    default_mesh_shape,
    gather_params,
    init_distributed,
    lm_param_specs,
    local_lm_config,
    make_mesh,
    rank_device,
    shard_batched_engine_for_serving,
    shard_engine_for_inference,
    shard_lm_for_inference,
    shard_lm_params,
    shard_params,
)
from .pipeline import make_pipeline_forward
from .serving import ShardedBatchedEngine, follow
