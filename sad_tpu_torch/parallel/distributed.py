"""Data parallelism over processes with ``torch.distributed`` (ref:
sad_tpu/parallel/mesh.py, which replaces the reference's muji / NCCL / Gloo
allreduce, its multi-node data_parallel_model with Gloo rendezvous, and its
host-side parameter broadcast, lib/utils/net.py:185-208, with the 'data' and
'dcn' mesh axes).

sad_tpu is single-controller: one process shards the global batch over a
mesh and XLA inserts the psum. The port keeps the same arithmetic in
PyTorch's multi-process idiom, one process a card, launched by
``torchrun --nnodes N --nproc_per_node W / N``:

- every rank draws the same global batch schedule and builds only its own
  contiguous block of images (``shard_rows``; ``check_group_layout``: W
  divides the batch's images). A loss group may span ranks (W > NUM_GPUS,
  or groups split unevenly): the steps then count each group's normalizers
  over the ranks with one all-reduce (train/train_step.mesh_losses, the
  R-CNN step's ``group_counts``);
- each rank's loss is that of its own images, scaled by 1 / G_global;
- the gradients are SUMMED over the ranks (``all_reduce_grads``), not
  averaged, and every rank applies the same momentum SGD. Over N nodes
  (parallel/mesh.create_multislice_mesh, sad_tpu's 'dcn' axis) the sum
  has two levels, within each node and then across nodes.

So W ranks compute what one process with G groups computes, in another
summation order (sad_tpu's claim for its mesh, train/train_step.py:12-15).
With world size 1 nothing here runs a collective.

The node layout is torchrun's: LOCAL_WORLD_SIZE ranks a node, node
GROUP_RANK holding ranks [GROUP_RANK * L, (GROUP_RANK + 1) * L). Without
those variables the job is one node.

Backends: NCCL for CUDA devices, gloo for the CPU, or the one the caller
names. A named backend that this PyTorch lacks raises; there is no quiet
switch. Gloo takes CUDA tensors for broadcast and all_reduce only, so the
two-level sum runs as two all-reduces under gloo and as reduce-scatter,
all-reduce and all-gather under NCCL; the object collectives travel
through the CPU.

``stats`` counts the bytes this rank hands to each level of the gradient
sum and to the count all-reduces and, with ``stats["timed"]`` set, their
host seconds (a device synchronisation before and after each).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import get_device

# flat gradient buckets of this many bytes: a few collectives a step, not one
# a parameter (DDP's default bucket is 25 MiB)
BUCKET_BYTES = 25 * 2 ** 20
# metrics whose per-rank value is a mean over the rank's groups: the mean of
# the ranks' values is the global mean (every rank holds G / W groups); every
# other metric is a sum over groups or rows and is summed (a RetinaNet or SAD
# step on a Mesh returns the global metrics itself)
MEAN_METRICS = ("distill_normalizer",)
# MODEL.TYPEs of the R-CNN family
RCNN_TYPES = ("generalized_rcnn", "rpn", "rfcn")


@dataclass(frozen=True)
class DistInfo:
    """This process's place in the world: world 1 without a process group."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    backend: Optional[str] = None
    local_world: int = 1  # ranks a node (torchrun's LOCAL_WORLD_SIZE)
    node: int = 0  # this rank's node (torchrun's GROUP_RANK)

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_LOCAL_RANK = 0
_LOCAL_WORLD = 1
_NODE = 0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def current() -> DistInfo:
    """The process group's rank and world, or world 1 when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        return DistInfo()
    return DistInfo(dist.get_rank(), dist.get_world_size(), _LOCAL_RANK, dist.get_backend(),
                    _LOCAL_WORLD, _NODE)


def init_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, device="cuda") -> DistInfo:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK, MASTER_ADDR / MASTER_PORT) or
    the arguments name; a no-op returning world 1 when neither does, and the
    existing group's place when one is already initialised. The node layout
    comes from LOCAL_WORLD_SIZE and GROUP_RANK (one node without them): it
    raises unless LOCAL_WORLD_SIZE divides the world and the node holds
    this rank, as torchrun numbers them.

    ``device`` is the kind of device the ranks train on: 'cuda' selects the
    card ``cuda:LOCAL_RANK`` (raising without one) and defaults the backend
    to NCCL, 'cpu' defaults it to gloo."""
    global _LOCAL_RANK, _LOCAL_WORLD, _NODE
    if dist.is_available() and dist.is_initialized():
        return current()
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK") if local_rank is None else local_rank
    if world_size is None:
        return DistInfo()
    if rank is None:
        raise ValueError(f"world size {world_size} given without this process's rank")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    node = _env_int("GROUP_RANK")
    node = rank // local_world if node is None else node
    if world_size % local_world or node != rank // local_world:
        raise ValueError(
            f"rank {rank} of {world_size} on node {node} of LOCAL_WORLD_SIZE {local_world}: the "
            "nodes must hold equal contiguous blocks of ranks, as torchrun numbers them")
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(
            f"torch.distributed backend {backend!r} is not available in this PyTorch "
            f"({torch.__version__}); sad_tpu_torch does not switch backends on its own")
    if kind == "cuda":
        torch.cuda.set_device(get_device(f"cuda:{local_rank}"))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _LOCAL_RANK, _LOCAL_WORLD, _NODE = local_rank, local_world, node
    return current()


def destroy() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` through ``device.get_device``
    (no fallback from the card), or the CPU when ``kind`` asks for it. Without
    a process group, ``get_device(kind)`` itself."""
    info = current()
    if info.world == 1 and not dist.is_initialized():
        return get_device(kind)
    if torch.device(kind).type == "cpu":
        return get_device("cpu")
    return get_device(f"cuda:{info.local_rank}")


def is_main() -> bool:
    return current().rank == 0


def world_size() -> int:
    return current().world


def check_group_layout(cfg, world: int) -> None:
    """The batch's images must divide over the ``world`` data ranks (the
    counterpart of shard_batch_tree's refusal of a misshaped batch,
    sad_tpu/parallel/mesh.py:87-111). A loss group may span ranks, on every
    step: the steps count its normalizers over the ranks."""
    groups, per = cfg.NUM_GPUS, cfg.TRAIN.IMS_PER_BATCH
    if world < 1 or (groups * per) % world:
        raise ValueError(
            f"{world} ranks cannot split the batch of NUM_GPUS = {groups} loss groups of "
            f"TRAIN.IMS_PER_BATCH = {per} images; the world size must divide its "
            f"{groups * per} images")


def shard_rows(x, rank: int, world: int):
    """The rank's contiguous block of the leading (image or group) axis of
    ``x`` (a tensor or an array); the axis must divide by ``world``."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"leading axis of {n} does not split over {world} ranks")
    k = n // world
    return x[rank * k:(rank + 1) * k]


def shard_batch(batch, rank: int, world: int):
    """``shard_rows`` of every array of a batch (nested level dicts kept,
    plain numbers passed through)."""
    if world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (int, float)):
        return batch
    return shard_rows(batch, rank, world)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[int]]:
    """Consecutive index lists of at most ``bucket_bytes`` float32 bytes (a
    larger tensor is a bucket of its own)."""
    out: List[List[int]] = []
    cur: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = 4 * t.numel()
        if cur and size + nbytes > bucket_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        out.append(cur)
    return out


stats = {"timed": False, "node_bytes": 0, "cross_bytes": 0, "flat_bytes": 0,
         "counts_bytes": 0, "node_s": 0.0, "cross_s": 0.0, "flat_s": 0.0, "counts_s": 0.0}


def reset_stats(timed: bool = False) -> None:
    for k in stats:
        stats[k] = 0.0 if k.endswith("_s") else 0
    stats["timed"] = timed


@contextmanager
def _stage(name: str, x: torch.Tensor):
    """Count ``x``'s bytes under ``name`` and, when timed, the collective's
    host seconds between two device synchronisations."""
    stats[f"{name}_bytes"] += x.numel() * x.element_size()
    timed = stats["timed"]
    if timed and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        stats[f"{name}_s"] += time.perf_counter() - t0


def reduction_transport(mesh=None) -> str:
    """How ``all_reduce_grads`` sums over ``mesh``: 'flat' (one all-reduce
    over the world), 'nccl two-level' (reduce-scatter in the node,
    all-reduce of the shard across nodes, all-gather in the node) or 'gloo
    two-level' (an all-reduce in the node, then one across nodes: gloo has
    no reduce-scatter of CUDA tensors)."""
    if mesh is None or mesh.n_slices == 1:
        return "flat"
    return f"{'nccl' if mesh.backend == 'nccl' else 'gloo'} two-level"


def sum_bucket(flat: torch.Tensor, mesh, how: Optional[str] = None) -> torch.Tensor:
    """The SUM over the ranks of one flat bucket (ref: sad_tpu's psum over
    ('dcn', 'data'), ICI within a slice, then DCN across), by ``how``
    (``reduction_transport(mesh)`` by default)."""
    how = how or reduction_transport(mesh)
    if how == "flat":
        with _stage("flat", flat):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat
    node, cross = mesh.node_group, mesh.cross_group
    if how == "gloo two-level":
        with _stage("node", flat):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=node)
        with _stage("cross", flat):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=cross)
        return flat
    n, per = flat.numel(), mesh.per_slice
    padded = torch.cat([flat, flat.new_zeros(-n % per)]) if n % per else flat
    shard = padded.new_empty(padded.numel() // per)
    with _stage("node", padded):
        dist.reduce_scatter_tensor(shard, padded, op=dist.ReduceOp.SUM, group=node)
    with _stage("cross", shard):
        dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=cross)
    with _stage("node", padded):
        dist.all_gather_into_tensor(padded, shard, group=node)
    return padded[:n]


def all_reduce_grads(grads: Iterable[torch.Tensor], mesh=None,
                     bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The SUM over the ranks of each gradient, through a few flat float32
    buckets: one all-reduce a bucket, or over a multislice ``mesh`` of more
    than one slice the two-level sum (``reduction_transport``); every rank
    ends with the same bits. With world size 1 the gradients themselves,
    with no collective."""
    grads = list(grads)
    if world_size() == 1:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in _buckets(grads, bucket_bytes):
        flat = sum_bucket(torch.cat([grads[i].reshape(-1).float() for i in idx]), mesh)
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view_as(grads[i]).to(grads[i].dtype)
            off += n
    return out


def grad_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes ``all_reduce_grads`` sends a step: every gradient as float32."""
    return sum(4 * t.numel() for t in tensors)


def all_reduce_metrics(packed: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """One collective on the packed metrics vector (``names`` in its order):
    sums over the ranks, and for MEAN_METRICS the mean; with world size 1
    the vector itself."""
    world = world_size()
    if world == 1:
        return packed
    dist.all_reduce(packed, op=dist.ReduceOp.SUM)
    mean = [i for i, n in enumerate(names) if n in MEAN_METRICS]
    if mean:
        packed[mean] = packed[mean] / world
    return packed


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The SUM over the ranks of a small tensor (in place); with world size 1
    the tensor itself."""
    if world_size() > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def all_reduce_counts(x: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` of a step's per-group partial counts, counted in
    ``stats`` under 'counts'."""
    if world_size() == 1:
        return x
    with _stage("counts", x):
        return all_reduce_sum(x)


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0,
                      bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite every tensor with rank ``src``'s value, through flat buckets
    of one dtype each."""
    tensors = [t for t in tensors]
    if world_size() == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            for idx in _buckets(group, bucket_bytes):
                flat = torch.cat([group[i].reshape(-1) for i in idx])
                dist.broadcast(flat, src=src)
                off = 0
                for i in idx:
                    n = group[i].numel()
                    group[i].copy_(flat[off:off + n].view_as(group[i]))
                    off += n


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank: the reference's
    host-side parameter broadcast (lib/utils/net.py:185-208)."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()), src)


def barrier() -> None:
    info = current()
    if info.world == 1:
        return
    if info.backend == "nccl":
        dist.barrier(device_ids=[info.local_rank])
    else:
        dist.barrier()


def gather_objects(obj: Any, dst: int = 0) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on rank ``dst`` (None on the
    others); ``[obj]`` with world size 1."""
    info = current()
    if info.world == 1:
        return [obj]
    out = [None] * info.world if info.rank == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
