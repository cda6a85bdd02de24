"""Data parallelism over `torch.distributed`: the mesh helpers
(`parallel/mesh.py`) and process groups, differentiable collectives and the
rank launcher (`parallel/distributed.py`)."""

from multimodalemotionrecognition_torch.parallel.distributed import (
    ALONE,
    BatchShard,
    all_gather_rows,
    all_reduce_sum,
    batch_shard,
    current_shard,
    is_multi_host,
    launch,
    local_device,
    maybe_initialize_distributed,
    rank,
    world_size,
)
from multimodalemotionrecognition_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "ALONE",
    "BatchShard",
    "Mesh",
    "all_gather_rows",
    "all_reduce_sum",
    "batch_shard",
    "current_shard",
    "is_multi_host",
    "launch",
    "local_device",
    "make_mesh",
    "maybe_initialize_distributed",
    "param_sharding_rules",
    "rank",
    "replicate",
    "shard_batch",
    "shard_params",
    "world_size",
]
