"""Halo exchange of row bands over a mesh's model group (the exchanges XLA
inserts when sad_tpu shards image height over 'model', sad_tpu/parallel/
mesh.py:76-84).

A level of H rows is split over the model group's n ranks by
``mesh.row_band``. An op whose output band needs input rows a rank does not
own gets them from their owners: ``halo(x, h, needs, pad, mesh)`` returns
this rank's band ``x`` extended to the rows ``needs[model_index]`` = [lo, hi)
(global row indices, lo may be < 0 and hi > h), the rows outside the image
filled with ``pad``. Its backward sends the gradient of each borrowed row
back to its owner, which adds it to its own.

The plan of who sends which rows to whom comes from global row indices
alone (``plan``): every rank of the group computes the same one from (h,
needs), so every send meets its receive. A rank with an empty band still
sends the rows it owns when a peer needs them, and one whose ``needs`` is
empty receives nothing.

Transport, chosen by the process group's backend:
- NCCL (a card a rank): ``dist.batch_isend_irecv``, card to card;
- gloo with CUDA tensors (ranks that share one card): PyTorch's gloo takes
  CUDA tensors for broadcast and all_reduce only, so the rows go through
  pinned host buffers; the convolutions stay on the card;
- gloo with CPU tensors: isend / irecv of the tensors themselves.

``stats`` counts the bytes this rank sent, its exchanges and, with
``stats["timed"]`` set, the host seconds they and ``gather_rows`` took (the
device synchronised before and after each, so that only a measurement run
sets it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, row_band

Rows = Tuple[int, int]

stats = {"bytes": 0, "exchanges": 0, "seconds": 0.0, "gather_seconds": 0.0, "timed": False}


def reset_stats(timed: bool = False) -> None:
    stats.update(bytes=0, exchanges=0, seconds=0.0, gather_seconds=0.0, timed=timed)


def transport(mesh: Mesh, device: torch.device) -> str:
    """'nccl', 'gloo-host' (CUDA tensors staged through pinned host memory)
    or 'gloo' (CPU tensors): how ``halo`` and ``gather_rows`` move rows."""
    if mesh.backend == "nccl":
        return "nccl"
    return "gloo-host" if device.type == "cuda" else "gloo"


@dataclass(frozen=True)
class Plan:
    """This rank's part of one exchange: its band [a, b) of an h-row level,
    the rows [lo, hi) it needs, and the (peer model index, start, stop)
    blocks it sends and receives."""

    a: int
    b: int
    lo: int
    hi: int
    sends: Tuple[Tuple[int, int, int], ...]
    recvs: Tuple[Tuple[int, int, int], ...]


def plan(h: int, needs: Sequence[Rows], me: int) -> Plan:
    """The exchange of model index ``me`` when model index q needs rows
    ``needs[q]`` of an h-row level (global indices, clipped to [0, h) for
    what is sent)."""
    n = len(needs)
    bands = [row_band(h, n, q) for q in range(n)]

    def block(owner: int, needer: int):
        lo, hi = needs[needer]
        a, b = bands[owner]
        r0, r1 = max(lo, a, 0), min(hi, b, h)
        return (owner if needer == me else needer, r0, r1) if r1 > r0 else None

    sends = tuple(x for q in range(n) if q != me for x in [block(me, q)] if x)
    recvs = tuple(x for q in range(n) if q != me for x in [block(q, me)] if x)
    a, b = bands[me]
    lo, hi = needs[me]
    return Plan(a, b, lo, max(hi, lo), sends, recvs)


def _exchange(mesh: Mesh, sends: List[Tuple[int, torch.Tensor]],
              recvs: List[Tuple[int, torch.Tensor]]) -> None:
    """Send each (peer model index, tensor) and receive into each (peer,
    destination view), all posted at once, then wait."""
    if not sends and not recvs:
        return
    timed = stats["timed"]
    dev = (sends or recvs)[0][1].device
    if timed and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ranks, group = mesh.model_ranks(), mesh.model_group
    way = transport(mesh, dev)
    host = way == "gloo-host"

    def buffer(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if host else (
            torch.empty(t.shape, dtype=t.dtype, device=t.device))

    out_bufs = []
    for q, t in sends:
        buf = buffer(t)
        buf.copy_(t)
        out_bufs.append((q, buf))
    in_bufs = [(q, buffer(dest)) for q, dest in recvs]
    if way == "nccl":
        ops = ([dist.P2POp(dist.irecv, buf, ranks[q], group) for q, buf in in_bufs]
               + [dist.P2POp(dist.isend, buf, ranks[q], group) for q, buf in out_bufs])
        reqs = dist.batch_isend_irecv(ops)
    else:
        reqs = ([dist.irecv(buf, ranks[q], group=group) for q, buf in in_bufs]
                + [dist.isend(buf, ranks[q], group=group) for q, buf in out_bufs])
    for req in reqs:
        req.wait()
    for (_, dest), (_, buf) in zip(recvs, in_bufs):
        dest.copy_(buf)
    stats["bytes"] += sum(t.numel() * t.element_size() for _, t in sends)
    stats["exchanges"] += 1
    if timed:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["seconds"] += time.perf_counter() - t0


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p: Plan, pad: float, mesh: Mesh):
        n, c, _, w = x.shape
        ext = x.new_full((n, c, p.hi - p.lo, w), pad)
        s0, s1 = max(p.lo, p.a), min(p.hi, p.b)
        if s1 > s0:
            ext[:, :, s0 - p.lo:s1 - p.lo] = x[:, :, s0 - p.a:s1 - p.a]
        _exchange(mesh, [(q, x[:, :, r0 - p.a:r1 - p.a]) for q, r0, r1 in p.sends],
                  [(q, ext[:, :, r0 - p.lo:r1 - p.lo]) for q, r0, r1 in p.recvs])
        ctx.plan, ctx.mesh, ctx.x_shape = p, mesh, x.shape
        return ext

    @staticmethod
    def backward(ctx, g):
        p, mesh = ctx.plan, ctx.mesh
        gx = g.new_zeros(ctx.x_shape)
        s0, s1 = max(p.lo, p.a), min(p.hi, p.b)
        if s1 > s0:
            gx[:, :, s0 - p.a:s1 - p.a] = g[:, :, s0 - p.lo:s1 - p.lo]
        # the reverse of the forward: borrowed rows' gradients go back to
        # their owners, who add what they receive to their own rows
        back = [(q, g.new_empty((g.shape[0], g.shape[1], r1 - r0, g.shape[3])))
                for q, r0, r1 in p.sends]
        _exchange(mesh, [(q, g[:, :, r0 - p.lo:r1 - p.lo]) for q, r0, r1 in p.recvs], back)
        for (_, r0, r1), (_, got) in zip(p.sends, back):
            gx[:, :, r0 - p.a:r1 - p.a] += got
        return gx, None, None, None


def halo(x: torch.Tensor, h: int, needs: Sequence[Rows], pad: float, mesh: Mesh
         ) -> torch.Tensor:
    """This rank's band ``x`` (N, C, rows, W) of an h-row level, extended to
    the rows ``needs[mesh.model_index]``: rows of other ranks exchanged,
    rows outside [0, h) set to ``pad``. ``needs`` holds every model index's
    rows, the same list on every rank."""
    p = plan(h, needs, mesh.model_index)
    if p.hi == p.lo and not p.sends:
        return x[:, :, :0]
    if not p.sends and not p.recvs:
        n, c, _, w = x.shape
        top, bottom = max(p.a - p.lo, 0), max(p.hi - p.b, 0)
        core = x[:, :, max(p.lo - p.a, 0):x.shape[2] - max(p.b - p.hi, 0)]
        if not top and not bottom:
            return core
        return torch.cat([x.new_full((n, c, top, w), pad), core,
                          x.new_full((n, c, bottom, w), pad)], dim=2)
    return _Halo.apply(x, p, pad, mesh)


def gather_rows(x: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """The model group's bands of an NHWC map (N, rows, W, C) of h rows,
    joined: each band padded to ceil(h / n) rows, all-gathered over the
    model group (through pinned host memory under gloo with CUDA tensors),
    then trimmed to h rows."""
    n = mesh.n_model
    if n == 1:
        return x
    timed, dev = stats["timed"], x.device
    if timed and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    c = -(-h // n)
    pad = x.new_zeros((x.shape[0], c - x.shape[1]) + tuple(x.shape[2:]))
    band = torch.cat([x, pad], dim=1).contiguous()
    src = band.cpu() if transport(mesh, dev) == "gloo-host" else band
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.model_group)
    out = torch.cat(parts, dim=1)[:, :h].to(dev)
    if timed:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["gather_seconds"] += time.perf_counter() - t0
    return out
