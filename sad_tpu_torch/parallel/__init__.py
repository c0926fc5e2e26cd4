"""Parallelism over GPUs with torch.distributed, the counterpart of
sad_tpu/parallel/mesh.py:

- the 'data' axis (``distributed``): one process a card, each holding its
  block of a batch's images, the gradients summed over the ranks;
  ``launch.spawn`` runs a function on W local ranks;
- the (data, model) mesh (``mesh``): rank r at data index r // n_model and
  model index r % n_model; over 'model' each rank holds a band of rows of its
  images (``mesh.row_band``, XLA's split of every level), ``spatial`` runs the
  RetinaNet on the bands and ``halo`` exchanges the rows each op lacks; loss
  groups may span ranks on every step (train/train_step.mesh_losses, the
  R-CNN step's group counts);
- the multislice mesh (``mesh.create_multislice_mesh``, sad_tpu's 'dcn'
  axis): the data ranks of a ``torchrun --nnodes N`` job in N slices, one a
  node, the gradients summed within each node and then across nodes
  (``distributed.all_reduce_grads(grads, mesh)``)."""

from .distributed import (
    DistInfo, all_reduce_grads, all_reduce_metrics, barrier, broadcast_module,
    broadcast_object, broadcast_tensors, check_group_layout, current, gather_objects,
    init_distributed, is_main, rank_device, shard_batch, shard_rows, world_size,
)
from .mesh import Mesh, create_mesh, create_multislice_mesh, shard_batch_tree

__all__ = [
    "DistInfo", "Mesh", "all_reduce_grads", "all_reduce_metrics", "barrier", "broadcast_module",
    "broadcast_object", "broadcast_tensors", "check_group_layout", "create_mesh",
    "create_multislice_mesh", "current",
    "gather_objects", "init_distributed", "is_main", "rank_device", "shard_batch",
    "shard_batch_tree", "shard_rows", "world_size",
]
