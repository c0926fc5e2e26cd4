"""A 2-D mesh of ranks, ('data', 'model') (ref: sad_tpu/parallel/mesh.py:31-43,
66-111).

sad_tpu lays its devices out as ``reshape(n_data, n_model)`` and shards a
batch's images over 'data' and their HEIGHT over 'model'; XLA splits every
level's rows and inserts the convolution halo exchanges. The port keeps the
layout in PyTorch's multi-process idiom: rank ``r`` sits at data index
``r // n_model`` and model index ``r % n_model``, every rank holds its data
shard's images and, of each, its band of rows (``row_band``: XLA's split of
an uneven dimension, so bands may be empty), and parallel/spatial.py runs
the model on the bands with the exchanges of parallel/halo.py.

    mesh = create_mesh(n_data=2, n_model=2)   # after init_distributed
    band = shard_batch_tree(batch, mesh)      # this rank's piece of a batch

The process groups: one model group for each data index (the ranks that
hold bands of the same images: halo exchanges and gathers), one data group
for each model index. Every rank creates all of them, in the same order, as
``dist.new_group`` requires. Without a process group the mesh is 1 x 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from .distributed import current

# batch keys whose arrays are split by rows over the model index: the
# canvases (B, H, W, 3) and each level's targets (B, H_l, W_l, ...)
ROW_KEYS = ("data", "teacher_data", "data_u8")
LEVEL_ROW_KEYS = ("labels", "bbox_targets", "fg_mask")


def row_band(n_rows: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [start, stop) of band ``index`` when ``n_rows`` rows split into
    ``parts`` bands as XLA splits an uneven dimension: c = ceil(n / parts)
    rows a band, the last ones shorter or empty."""
    c = -(-n_rows // parts)
    return min(index * c, n_rows), min((index + 1) * c, n_rows)


@dataclass
class Mesh:
    """(n_data, n_model) ranks; this rank's place and its groups."""

    n_data: int
    n_model: int
    rank: int = 0
    backend: Optional[str] = None
    model_groups: List[Any] = field(default_factory=list, repr=False)
    data_groups: List[Any] = field(default_factory=list, repr=False)

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def model_group(self):
        """The group of the ranks that hold bands of this rank's images."""
        return self.model_groups[self.data_index] if self.model_groups else None

    @property
    def data_group(self):
        return self.data_groups[self.model_index] if self.data_groups else None

    def model_ranks(self) -> List[int]:
        """The global ranks of this rank's model group, by model index."""
        d = self.data_index
        return [d * self.n_model + m for m in range(self.n_model)]

    @property
    def is_model_first(self) -> bool:
        """The first rank of its model group (the one that decodes)."""
        return self.model_index == 0

    def band(self, n_rows: int, index: Optional[int] = None) -> Tuple[int, int]:
        """This rank's rows (or model index ``index``'s) of a level of
        ``n_rows`` rows."""
        return row_band(n_rows, self.n_model, self.model_index if index is None else index)


def create_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the process group's world (or the
    1 x 1 mesh without one); raises unless n_data x n_model is the world
    (sad_tpu's assert, mesh.py:37-39). Collective: every rank calls it."""
    info = current()
    if n_data is None:
        n_data = info.world // n_model
    if n_data * n_model != info.world or n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {info.world} ranks")
    mesh = Mesh(n_data, n_model, info.rank, info.backend)
    if info.world > 1:
        mesh.model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                             for d in range(n_data)]
        mesh.data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                            for m in range(n_model)]
        if info.backend == "nccl":
            # a collective first on each of this rank's groups: NCCL's
            # point-to-point calls want their communicator made by one
            dev = torch.device("cuda", torch.cuda.current_device())
            for g in (mesh.model_group, mesh.data_group):
                dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return mesh


def _rows(x, mesh: Mesh):
    """The rank's band of axis 1 of ``x``."""
    r0, r1 = mesh.band(x.shape[1])
    return x[:, r0:r1]


def shard_batch_tree(batch, mesh: Mesh):
    """This rank's piece of a whole batch (numpy arrays or tensors, level
    dicts kept; ref: shard_batch_tree and spatial_sharding, sad_tpu
    mesh.py:76-111):

    - an array whose leading axis divides by n_data: the rank's block of it;
      the canvases (ROW_KEYS) and each level's targets (LEVEL_ROW_KEYS) then
      also cut to the rank's band of rows (``Mesh.band``);
    - a 1-D array whose length does not divide (the per-group fg_num when
      the groups are fewer than the data ranks, or split unevenly):
      replicated;
    - any other array that does not divide raises: a misshaped batch.

    With n_model > 1 the piece also holds ``canvas_h``, the canvas height
    its bands are rows of."""
    n = mesh.n_data

    def put(x, rows: bool):
        if isinstance(x, (int, float)):
            return x
        shape = tuple(x.shape)
        if len(shape) >= 1 and shape[0] % n == 0 and shape[0] > 0:
            k = shape[0] // n
            x = x[mesh.data_index * k:(mesh.data_index + 1) * k]
            return _rows(x, mesh) if rows and mesh.n_model > 1 else x
        if len(shape) >= 2:
            raise ValueError(
                f"batch array of shape {shape} cannot be data-sharded over {n} devices "
                "(leading dim not divisible); fix the batch size instead of training "
                "replicated")
        return x

    out = {}
    for key, v in batch.items():
        if isinstance(v, dict):
            out[key] = {lvl: put(x, key in LEVEL_ROW_KEYS) for lvl, x in v.items()}
        else:
            out[key] = put(v, key in ROW_KEYS)
    if mesh.n_model > 1:
        canvas = next(batch[k] for k in ROW_KEYS if k in batch)
        out["canvas_h"] = int(canvas.shape[1])
    return out

