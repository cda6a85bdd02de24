"""Data and tensor parallelism: the mesh helpers and sharding rules
(`parallel/mesh.py`), process groups, differentiable collectives and the
rank launcher (`parallel/distributed.py`), and the tensor-parallel layers
that split a replica's WavLM trunk over its mesh row
(`parallel/tensor.py`, whose docstring says why the model axis runs inside
one process)."""

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
    local_row,
    maybe_initialize_distributed,
    rank,
    world_size,
)
from multimodalemotionrecognition_torch.parallel.mesh import (
    Mesh,
    gather_params,
    make_mesh,
    param_sharding_rules,
    replicate,
    shard_batch,
    shard_params,
)
from multimodalemotionrecognition_torch.parallel.tensor import (
    ColumnParallelLinear,
    RowParallelLinear,
    ordered_sum,
    shard_module_,
)

__all__ = [
    "ALONE",
    "BatchShard",
    "ColumnParallelLinear",
    "Mesh",
    "RowParallelLinear",
    "all_gather_rows",
    "all_reduce_sum",
    "batch_shard",
    "current_shard",
    "gather_params",
    "is_multi_host",
    "launch",
    "local_device",
    "local_row",
    "make_mesh",
    "maybe_initialize_distributed",
    "ordered_sum",
    "param_sharding_rules",
    "rank",
    "replicate",
    "shard_batch",
    "shard_module_",
    "shard_params",
    "world_size",
]
