"""Data parallelism over processes, one per card (byogan_tpu/parallel/)."""

from byogan_tpu_torch.parallel.mesh import (
    AllReduceSum,
    DataMesh,
    agree,
    all_reduce_mean_,
    barrier,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_train_state,
)

__all__ = [
    "AllReduceSum",
    "DataMesh",
    "agree",
    "all_reduce_mean_",
    "barrier",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "shard_train_state",
]
