"""Data parallelism over GPUs with torch.distributed (the counterpart of
sad_tpu/parallel/mesh.py's 'data' axis); ``launch.spawn`` runs a function
on W local ranks."""

from .distributed import (
    DistInfo, all_reduce_grads, all_reduce_metrics, barrier, broadcast_module,
    broadcast_object, broadcast_tensors, check_group_layout, current, gather_objects,
    init_distributed, is_main, rank_device, shard_batch, shard_rows, world_size,
)

__all__ = [
    "DistInfo", "all_reduce_grads", "all_reduce_metrics", "barrier", "broadcast_module",
    "broadcast_object", "broadcast_tensors", "check_group_layout", "current", "gather_objects",
    "init_distributed", "is_main", "rank_device", "shard_batch", "shard_rows", "world_size",
]
