"""Asynchronous checkpoints with retention: TRAIN.CHECKPOINT_BACKEND 'orbax'
(the counterpart of sad_tpu/train/orbax_checkpoint.py, which wraps orbax, a
JAX library; this backend gives what it gives with torch alone).

    ckptr = AsyncCheckpointer(os.path.join(output_dir, "checkpoints"))
    ckptr.save(step, model, velocity)   # returns once the copies are queued
    ...
    ckptr.latest_step(); ckptr.restore()  # the payload dict of the newest step
    ckptr.wait(); ckptr.close()

A save copies the parameters and the momentum into pinned host buffers
(kept from one save to the next) with ``non_blocking`` copies on the current
stream, records an event, and returns: the optimizer's in-place
``_foreach_`` update of the next step is queued on the same stream after the
copies, so the snapshot holds the weights of the step it names, never torn
ones. A writer thread waits on the event, builds the pickle backend's own
payload (train/checkpoint.checkpoint_payload: sad_tpu's native dict, so a
step loads wherever a model_iter{N}.pkl loads) and writes it to
``<step>.tmp/checkpoint.pkl``, then renames the directory to ``<step>/``:
``latest_step()`` never sees a partial step, and a leftover ``.tmp`` is
ignored. It then keeps the newest ``max_to_keep`` steps, removing older
step directories this class wrote. At most one save is in flight: the next
save, ``wait()`` and ``close()`` wait for it and raise what it raised.

``stats`` records each save's host seconds in ``save`` (the loop's stall),
the part of them spent waiting for the save before it, the writer's
seconds and the bytes written.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .checkpoint import checkpoint_payload, load_checkpoint, write_checkpoint

PAYLOAD = "checkpoint.pkl"


class AsyncCheckpointer:
    """Checkpoints of {params, velocity, iter} in ``directory/<step>/``."""

    def __init__(self, directory: str, max_to_keep: int = 5, create: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if create:
            os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._host: Dict[tuple, torch.Tensor] = {}
        self.stats: Dict[str, List[float]] = {"save_seconds": [], "wait_seconds": [],
                                              "write_seconds": [], "bytes": []}

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The complete steps this class wrote, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, PAYLOAD)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _host_copy(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._host[key] = buf
        buf.copy_(t.detach(), non_blocking=t.is_cuda)
        return buf

    def save(self, step: int, model: nn.Module,
             velocity: Optional[Dict[str, torch.Tensor]] = None, cfg_yaml: str = "") -> None:
        """Snapshot ``model``'s state_dict and ``velocity`` as ``step``: the
        copies are queued and a writer thread takes it from there."""
        t0 = time.perf_counter()
        self.wait()
        self.stats["wait_seconds"].append(time.perf_counter() - t0)
        sd = model.state_dict()
        params = {k: self._host_copy(("params", k), v) for k, v in sd.items()}
        vel = (None if velocity is None else
               {k: self._host_copy(("velocity", k), v) for k, v in velocity.items()})
        event = None
        if any(v.is_cuda for v in sd.values()):
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(
            target=self._write, args=(int(step), params, vel, event, cfg_yaml),
            name=f"async-checkpoint-{int(step)}", daemon=True)
        self._thread.start()
        self.stats["save_seconds"].append(time.perf_counter() - t0)

    def _write(self, step, params, vel, event, cfg_yaml) -> None:
        try:
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            tmp = os.path.join(self.directory, f"{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            write_checkpoint(os.path.join(tmp, PAYLOAD),
                             checkpoint_payload(params, vel, step, cfg_yaml))
            size = os.path.getsize(os.path.join(tmp, PAYLOAD))
            final = self.step_dir(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old))
            self.stats["write_seconds"].append(time.perf_counter() - t0)
            self.stats["bytes"].append(size)
        except Exception as e:  # raised by the next wait()
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight is written; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The payload dict of ``step`` (the latest when None), or None when
        there is no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_checkpoint(os.path.join(self.step_dir(step), PAYLOAD))

    def close(self) -> None:
        """Wait for the save in flight and drop the host buffers."""
        try:
            self.wait()
        finally:
            self._host.clear()
