"""Data and model parallelism over processes, one per card (byogan_tpu/parallel/)."""

from byogan_tpu_torch.parallel.mesh import (
    AllReduceSum,
    DataMesh,
    Mesh,
    agree,
    all_reduce_mean_,
    barrier,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_train_state,
)
from byogan_tpu_torch.parallel.tensor import (
    CopyToModel,
    GatherChannels,
    ReduceFromModel,
    SplitChannels,
    gather_state_dict,
    shard_state_dict,
    sharding_for_param,
)

__all__ = [
    "AllReduceSum",
    "CopyToModel",
    "DataMesh",
    "GatherChannels",
    "Mesh",
    "ReduceFromModel",
    "SplitChannels",
    "agree",
    "all_reduce_mean_",
    "barrier",
    "gather_state_dict",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "shard_state_dict",
    "shard_train_state",
    "sharding_for_param",
]
