"""Run a function on W ranks, each in a process of its own, as torchrun
would, and wait for all of them with a timeout.

    results = spawn(fn, world=2, args=(...), device="cpu", timeout_s=120)

Ranks run on the card unless ``device="cpu"`` asks for the CPU: with the
default ``cuda`` on a host without one, ``spawn`` raises before it starts a
rank.

Each rank process gets torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
LOCAL_WORLD_SIZE / GROUP_RANK in its environment, as ``torchrun --nnodes N
--nproc_per_node W / N`` gives them with ``nodes=N`` (LOCAL_RANK r % (W / N),
GROUP_RANK r // (W / N)): one host stands in for N nodes. It joins a
process group that meets through a ``file://`` store in a fresh temporary
directory (no port, so runs side by side cannot collide), calls ``fn(*args)`` and hands its return value back through a
file. ``fn`` must be importable by name (a module-level function): ranks
start with the 'spawn' method. A rank that raises, dies, or outlives the
timeout fails the whole run: the others are terminated (a rank waiting in a
collective for a dead peer would wait forever) and ``spawn`` raises with
each failed rank's traceback. Every process it starts is ended before it
returns: a rank leads a process group of its own, which also holds the
processes it starts (the loader's workers), and the whole group is ended.

``local_ranks`` maps ranks to cards, whatever the nodes: by default rank r
uses ``cuda:r``; two ranks that share one card (``local_ranks=[0, 0]``) must use gloo, since
NCCL refuses two ranks on one device. With ``log_prefix`` each rank's
standard output and error go to ``<log_prefix>.rank<r>.log``, whose tail a
failure quotes.
"""

from __future__ import annotations

import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

_POLL_S = 0.05
_TERM_S = 5.0


def _rank_main(rank: int, world: int, local_rank: int, backend: Optional[str],
               init_method: str, device: str, fn: Callable, args: tuple,
               out_path: str, threads: Optional[int], log_path: Optional[str],
               nodes: int = 1) -> None:
    os.setpgid(0, 0)
    # a terminated rank unwinds (the loader shuts its workers down)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if log_path:
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
    per = world // nodes
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per),
                      LOCAL_WORLD_SIZE=str(per), GROUP_RANK=str(rank // per))
    try:
        import torch

        from .distributed import destroy, init_distributed

        if threads:
            torch.set_num_threads(threads)
        init_distributed(rank, world, local_rank, backend, init_method, device)
        try:
            value = fn(*args)
            leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
            if leaked:
                raise RuntimeError(f"a rank process of sad_tpu_torch imported {leaked[:3]}")
        finally:
            destroy()
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(out_path + ".tmp", out_path)
    except BaseException:  # noqa: BLE001 -- handed to the parent, which raises
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _signal_group(p, sig) -> None:
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _end(procs) -> None:
    """Every rank's process group ended: SIGTERM, then SIGKILL to what is
    left after a grace period."""
    for p in procs:
        if p.is_alive():
            _signal_group(p, signal.SIGTERM)
    deadline = time.monotonic() + _TERM_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        _signal_group(p, signal.SIGKILL)
        p.join()


def spawn(fn: Callable, world: int, args: tuple = (), *, device: str = "cuda",
          backend: Optional[str] = None, local_ranks: Optional[Sequence[int]] = None,
          timeout_s: float = 120.0, threads: Optional[int] = None,
          log_prefix: Optional[str] = None, nodes: int = 1) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1; their return values in rank order.
    ``device`` ('cpu' or 'cuda') picks each rank's device and the default
    backend (gloo, NCCL); ``threads`` sets torch's intra-op threads a rank;
    ``nodes`` the nodes the ranks' environment describes."""
    import multiprocessing as mp

    from ..device import get_device

    get_device(device.split(":")[0])  # no card: raise here, before any rank starts

    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    if len(local_ranks) != world:
        raise ValueError(f"{len(local_ranks)} local ranks for a world of {world}")
    if nodes < 1 or world % nodes:
        raise ValueError(f"{nodes} nodes do not divide a world of {world}")
    tmp = tempfile.mkdtemp(prefix="sad_tpu_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = []
    paths = [os.path.join(tmp, f"rank{r}") for r in range(world)]
    logs = [f"{log_prefix}.rank{r}.log" if log_prefix else None for r in range(world)]
    try:
        for r in range(world):
            p = ctx.Process(target=_rank_main, name=f"rank{r}", args=(
                r, world, local_ranks[r], backend, init_method, device, fn, args, paths[r],
                threads, logs[r], nodes))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                _end(procs)
                raise TimeoutError(
                    f"{world} ranks of {fn.__name__} not done after {timeout_s:.0f} s "
                    f"(alive: {[p.name for p in procs if p.exitcode is None]}); terminated")
            time.sleep(_POLL_S)
        _end(procs)
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            msgs = []
            for r, code in failed:
                err = paths[r] + ".err"
                tb = open(err).read() if os.path.exists(err) else "(no traceback: terminated)"
                if logs[r] and os.path.exists(logs[r]):
                    with open(logs[r], errors="replace") as f:
                        tb = "".join(f.readlines()[-40:]) + tb
                msgs.append(f"--- rank {r} exit code {code}:\n{tb}")
            raise RuntimeError(f"{fn.__name__} failed on {len(failed)} of {world} ranks\n"
                               + "\n".join(msgs))
        out = []
        for path in paths:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _end(procs)
        shutil.rmtree(tmp, ignore_errors=True)
