from rlipv2_tpu_torch.parallel.dist_eval import DistEvalBuffer, pad_gt_arrays, shard_indices, unpack_gt_arrays
from rlipv2_tpu_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    batch_sharding,
    create_mesh,
    data_axis,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "DataParallel",
    "Mesh",
    "data_axis",
    "DistEvalBuffer",
    "pad_gt_arrays",
    "shard_indices",
    "unpack_gt_arrays",
]
