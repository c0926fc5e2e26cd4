"""A 2-D mesh of ranks, ('data', 'model'), and the multislice mesh,
('dcn', 'data', 'model') (ref: sad_tpu/parallel/mesh.py:31-111).

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

The multislice mesh (``create_multislice_mesh``, sad_tpu's replacement for
the reference's multi-node data_parallel_model and Gloo rendezvous) splits
the data ranks into ``n_slices`` slices, the nodes of a ``torchrun --nnodes
N`` job: rank r sits in slice r // L (L ranks a slice) at local index
r % L, with n_model = 1. Its data index over ('dcn', 'data') is r itself,
as sad_tpu's batch_sharding shards over both axes, so ``shard_batch_tree``
cuts the blocks of ``create_mesh(W)``. Its groups add a node group for each
slice and a cross-node group for each local index, over which
distributed.all_reduce_grads sums in two levels: within the node, then
across nodes. With one slice it is ``create_mesh(W)``.

    mesh = create_multislice_mesh()           # the nodes of torchrun's job
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
    """(n_data, n_model) ranks, the data ranks in ``n_slices`` slices; this
    rank's place and its groups."""

    n_data: int
    n_model: int
    rank: int = 0
    backend: Optional[str] = None
    model_groups: List[Any] = field(default_factory=list, repr=False)
    data_groups: List[Any] = field(default_factory=list, repr=False)
    n_slices: int = 1
    node_groups: List[Any] = field(default_factory=list, repr=False)
    cross_groups: List[Any] = field(default_factory=list, repr=False)

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

    @property
    def per_slice(self) -> int:
        """Ranks a slice (a node's LOCAL_WORLD_SIZE)."""
        return self.world // self.n_slices

    @property
    def slice_index(self) -> int:
        return self.rank // self.per_slice

    @property
    def local_index(self) -> int:
        return self.rank % self.per_slice

    @property
    def node_group(self):
        """The group of this rank's slice (node)."""
        return self.node_groups[self.slice_index] if self.node_groups else None

    @property
    def cross_group(self):
        """The group of the ranks at this rank's local index on every node."""
        return self.cross_groups[self.local_index] if self.cross_groups else None

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
        _warm(mesh, (mesh.model_group, mesh.data_group))
    return mesh


def _warm(mesh: Mesh, groups) -> None:
    """Under NCCL a collective first on each of this rank's ``groups``:
    NCCL's point-to-point calls want their communicator made by one."""
    if mesh.backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        for g in groups:
            dist.all_reduce(torch.zeros(1, device=dev), group=g)


def slice_groups(world: int, n_slices: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The ranks of each node group (slice s: [s L, (s + 1) L)) and of each
    cross-node group (local index i: {i, L + i, ...}) of ``world`` ranks in
    ``n_slices`` slices of L; raises unless n_slices divides the world."""
    if n_slices < 1 or world % n_slices:
        raise ValueError(f"{n_slices} slices do not divide {world} ranks")
    per = world // n_slices
    return ([list(range(s * per, (s + 1) * per)) for s in range(n_slices)],
            [[s * per + i for s in range(n_slices)] for i in range(per)])


def create_multislice_mesh(n_slices: Optional[int] = None) -> Mesh:
    """The ('dcn', 'data', 'model') mesh over the process group's world
    (ref: sad_tpu/parallel/mesh.py:46-63): ``n_slices`` slices (the nodes of
    torchrun's job by default, ``DistInfo.nodes``) of world / n_slices data
    ranks each, n_model = 1; raises unless n_slices divides the world
    (sad_tpu's assert, :61). Collective: every rank calls it."""
    info = current()
    n_slices = info.nodes if n_slices is None else n_slices
    nodes, crosses = slice_groups(info.world, n_slices)
    mesh = create_mesh(info.world, 1)
    mesh.n_slices = n_slices
    if n_slices > 1:
        mesh.node_groups = [dist.new_group(r) for r in nodes]
        mesh.cross_groups = [dist.new_group(r) for r in crosses]
        _warm(mesh, (mesh.node_group, mesh.cross_group))
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

