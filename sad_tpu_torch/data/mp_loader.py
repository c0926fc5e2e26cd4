"""Multi-process host data pipeline.

A copy of sad_tpu/data/mp_loader.py. The threaded TrainingLoader
(data/loader.py) is bound by the interpreter lock: minibatch building is
numpy-hot (decode, resize, anchor labeling), while one card consumes a
batch in tens of milliseconds. The reference sidesteps the lock because cv2
releases it (lib/roi_data/loader.py:66-115); the equivalent here is real
processes.

Design: worker processes each hold a private copy of the roidb(s) and the
minibatch builder (pickled once at spawn; the builders hold only numpy and
Python values). A dispatcher thread in the parent samples batch index lists
from the SAME epoch-shuffled, aspect-grouped streams as the threaded loader
(loader._Stream) and assigns the SAME deterministic per-batch seeds; the
collector restores DISPATCH order with per-stream sequence numbers, so the
surfaced batch stream is identical to a 1-thread TrainingLoader for ANY
num_workers. With ``rank`` / ``world`` the workers build only the rank's
block of each batch (loader.RankShard). Each built batch (a dict of numpy
arrays) is written by its worker into one file of a spool directory and
read back by the collector in one read, into per-stream host queues; the
consumer-facing surface (get_next_batch with strict labeled/unlabeled parity alternation,
queue_depth, shutdown, context manager, build_seconds, served) matches
TrainingLoader, so DevicePrefetcher and the train loop are oblivious.

Semi-supervised semantics preserved from the reference: the dispatcher
fills whichever stream is further behind (lib/roi_data/loader.py:109-115);
get_next_batch strictly alternates by batch parity (loader.py:140-146).

Worker errors are shipped back as formatted tracebacks and re-raised on the
consumer thread after already-built batches drain; a worker that dies
without one (OOM kill, native crash) is detected by a liveness scan. Uses
the 'spawn' start method: the parent has live CUDA and threads that must
not be forked. A worker never touches the card: it reports an error if
CUDA was initialised in it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import Config
from .loader import (
    _SHUTDOWN_JOIN_S, GET_TIMEOUT_S, _check_deadline, _drain, _Stream, _wait_until,
    fast_forward_streams, rank_builder, stream_for_batch,
)
from .minibatch import RetinaNetMinibatchBuilder

_SENTINEL = "__stop__"
_ERROR = "__error__"


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


_ALIGN = 64  # byte alignment of each array in a spool file


class _ArrayRef(NamedTuple):
    """An array of a spool file."""

    dtype: str
    shape: Tuple[int, ...]
    offset: int


def spool_batch(batch, path: str):
    """Write a batch's arrays into one file at ``path``; returns its layout:
    the batch with every array replaced by (dtype, shape, offset). Plain
    numbers stay in the layout."""
    offset = 0
    arrays = []

    def plan(v):
        nonlocal offset
        if isinstance(v, dict):
            return {k: plan(x) for k, x in v.items()}
        if not isinstance(v, np.ndarray):
            return v
        a = np.ascontiguousarray(v)
        arrays.append((offset, a))
        entry = _ArrayRef(a.dtype.str, tuple(a.shape), offset)
        offset += -(-a.nbytes // _ALIGN) * _ALIGN
        return entry

    layout = plan(batch)
    with open(path, "wb") as f:
        for off, a in arrays:
            f.seek(off)
            f.write(memoryview(a.reshape(-1)).cast("B"))
        f.truncate(offset)
    return layout


def unspool_batch(path: str, layout):
    """Read a spool file in one read into a fresh buffer, remove the file,
    and rebuild the batch as views of that buffer."""
    size = os.path.getsize(path)
    buf = np.empty(size, np.uint8)
    with open(path, "rb") as f:
        if f.readinto(memoryview(buf)) != size:
            raise OSError(f"short read of {path}")
    os.unlink(path)

    def build(v):
        if isinstance(v, dict):
            return {k: build(x) for k, x in v.items()}
        if not isinstance(v, _ArrayRef):
            return v
        dtype, shape, off = v
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        return buf[off:off + n].view(dt).reshape(shape)

    return build(layout)


def _worker_loop(task_q, result_q, builder, roidbs, spool_dir):
    # the decode and resize pool of cv2 (when present) sizes itself to the
    # host's cores in every worker: one thread each, as OMP_NUM_THREADS=1
    # keeps numpy's pools
    cv2 = sys.modules.get("cv2")
    if cv2 is not None:
        cv2.setNumThreads(1)
    while True:
        task = task_q.get()
        if task == _SENTINEL:
            return
        stream, seq, indices, seed = task
        try:
            entries = [roidbs[stream][i] for i in indices]
            t0 = time.perf_counter()
            built = builder.build(entries, seed=seed)
            batch = built.as_pytree() if hasattr(built, "as_pytree") else built
            if _cuda_initialized():
                raise RuntimeError("CUDA was initialised in a minibatch worker")
            path = os.path.join(spool_dir, f"{stream}-{seq}.batch")
            layout = spool_batch(batch, path)
            result_q.put((stream, seq, (path, layout, time.perf_counter() - t0)))
        except BaseException:  # noqa: BLE001 — ship to parent
            result_q.put((_ERROR, 0, traceback.format_exc()))
            return


class MultiprocessTrainingLoader:
    """Process-pool minibatch building behind the TrainingLoader interface."""

    def __init__(
        self,
        cfg: Config,
        roidb: List[dict],
        teacher_cfg: Optional[Config] = None,
        unlabeled_roidb: Optional[List[dict]] = None,
        batch_images: int = None,
        num_workers: int = None,
        queue_capacity: int = 4,
        seed: int = 3,
        builder=None,
        skip_batches: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        self.cfg = cfg
        self.batch_images = batch_images or (
            cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS
        )
        self.builder = rank_builder(builder or RetinaNetMinibatchBuilder(cfg, teacher_cfg),
                                    self.batch_images, rank, world)
        self.num_workers = num_workers or max(1, (os.cpu_count() or 2) - 1)
        self._capacity = queue_capacity
        self._seed = seed
        self.labeled = _Stream(roidb, self.batch_images, seed)
        self.unlabeled = (
            _Stream(unlabeled_roidb, self.batch_images, seed + 1)
            if unlabeled_roidb
            else None
        )
        self._streams = {"labeled": self.labeled}
        if self.unlabeled:
            self._streams["unlabeled"] = self.unlabeled
        self._roidbs = {"labeled": roidb}
        if unlabeled_roidb:
            self._roidbs["unlabeled"] = unlabeled_roidb

        # UNBOUNDED consumer queues: the dispatcher's backlog accounting
        # (_lagging_stream, qsize + inflight < capacity + 1) is the real
        # memory bound, so a bounded put buys nothing — and it deadlocked
        # the single collector (sad_tpu, round 4): blocked put()ing to the
        # full labeled queue, unable to move the unlabeled result the
        # consumer was waiting on.
        self._queues: Dict[str, queue.Queue] = {
            name: queue.Queue() for name in self._streams
        }
        # order restoration: batches are surfaced in DRAW order, not
        # completion order, so the batch stream is identical for any
        # num_workers. The sequence number is the stream's own draw counter
        # (atomic with the draw).
        self._next_seq = {name: 0 for name in self._streams}
        self._pending: Dict[str, Dict[int, object]] = {
            name: {} for name in self._streams
        }
        self._inflight = {name: 0 for name in self._streams}
        self._inflight_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._batch_parity = 0
        self.build_seconds: List[Tuple[str, float]] = []
        self.served: List[str] = []
        if skip_batches:
            fast_forward_streams(self.labeled, self.unlabeled, skip_batches)
            self._batch_parity = skip_batches
            self._next_seq = {
                name: self._streams[name].count for name in self._streams
            }

        # built batches come back as files (spool_batch): one write in the
        # worker and one read here, where a pipe moved each batch in 64 KB
        # chunks through the collector thread and bounded the whole loader
        # (~80 MB/s on the card's host: 245 MB a Mask R-CNN batch)
        self._spool_dir = tempfile.mkdtemp(prefix="sad_tpu_torch_batches_")
        self._ctx = mp.get_context("spawn")
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        self._procs: List[mp.Process] = []
        self._dispatcher = threading.Thread(
            target=self._dispatch, daemon=True, name="mp-loader-dispatch"
        )
        self._collector = threading.Thread(
            target=self._collect, daemon=True, name="mp-loader-collect"
        )

    # ---------------------------------------------------------------- start

    def start(self, prefill: bool = False, timeout: float = 600.0):
        # BLAS/OpenMP pools size themselves when the child imports numpy —
        # during spawn bootstrap, BEFORE the worker function runs. Default
        # the env in the parent around the spawns (children inherit it) so N
        # workers don't each open a full cores-wide thread pool; an
        # operator's explicit OMP_NUM_THREADS setting is honored.
        prior_omp = os.environ.get("OMP_NUM_THREADS")
        if prior_omp is None:
            os.environ["OMP_NUM_THREADS"] = "1"
        try:
            for i in range(self.num_workers):
                p = self._ctx.Process(
                    target=_worker_loop,
                    args=(
                        self._task_q, self._result_q, self.builder,
                        self._roidbs, self._spool_dir,
                    ),
                    daemon=True,
                    name=f"mp-loader-{i}",
                )
                p.start()
                self._procs.append(p)
        finally:
            if prior_omp is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = prior_omp
        self._dispatcher.start()
        self._collector.start()
        if prefill:
            # queues are unbounded (full() is never true): prefill to the
            # dispatcher's capacity bound instead
            target = self._capacity * len(self._queues)
            _wait_until(lambda: self.queue_depth() >= target or self._error is not None
                        or self._stop.is_set(), timeout, "loader prefill")
        return self

    # ------------------------------------------------------------- dispatch

    def _lagging_stream(self) -> Optional[str]:
        """Next stream to fill: whichever is further behind its capacity,
        counting batches already built and batches in flight."""
        with self._inflight_lock:
            backlog = {
                name: self._queues[name].qsize() + self._inflight[name]
                for name in self._streams
            }
            candidates = [
                n for n, b in backlog.items() if b < self._capacity + 1
            ]
            if not candidates:
                return None
            name = min(candidates, key=backlog.get)
            self._inflight[name] += 1
            return name

    def _dispatch(self):
        while not self._stop.is_set():
            name = self._lagging_stream()
            if name is None:
                time.sleep(0.01)
                continue
            stream = self._streams[name]
            # ship indices, not entries — workers hold their own roidb copy;
            # identical PER-STREAM seed schedule to the threaded loader
            idxs, bseed, seq = stream.next_batch_indices_seeded()
            self._task_q.put((name, seq, idxs, bseed))

    def _check_dead_workers(self) -> bool:
        """Liveness: a worker that died WITHOUT shipping a traceback
        (OOM-kill, SIGKILL, segfault in native code) would otherwise hang the
        consumer — its claimed _inflight slot (or its hole in the restored
        sequence) is never released. Any abnormal exit is fatal; exitcode 0
        means a clean return whose _ERROR message, if any, is already in the
        queue. Called periodically from the collector REGARDLESS of result
        traffic: with N-1 surviving workers the result pipe may never
        starve, so starvation alone is not a usable death signal."""
        dead = [
            p for p in self._procs
            if not p.is_alive() and p.exitcode not in (None, 0)
        ]
        if dead:
            codes = [p.exitcode for p in dead]
            self._error = RuntimeError(
                f"{len(dead)} minibatch worker(s) died (exit codes "
                f"{codes}) without reporting an error — likely OOM "
                "or a native crash"
            )
            self._stop.set()
            return True
        return False

    def _collect(self):
        last_scan = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_scan > 0.5:
                last_scan = now
                if self._check_dead_workers():
                    return
            try:
                kind, seq, payload = self._result_q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return  # shutdown terminates workers (exitcode -15)
                continue
            except (EOFError, OSError):
                return
            if kind == _ERROR:
                self._error = RuntimeError(
                    f"minibatch worker failed:\n{payload}"
                )
                self._stop.set()
                return
            path, layout, seconds = payload
            batch = unspool_batch(path, layout)
            self.build_seconds.append((kind, seconds))
            # restore dispatch order: hold out-of-order completions until
            # every earlier sequence number for this stream has surfaced
            self._pending[kind][seq] = batch
            while self._next_seq[kind] in self._pending[kind]:
                item = self._pending[kind].pop(self._next_seq[kind])
                # unbounded put (see __init__): the collector must NEVER
                # block — a blocked collector can't surface the OTHER
                # stream's results and deadlocks the parity-alternating
                # consumer
                self._queues[kind].put(item)
                self._next_seq[kind] += 1
                with self._inflight_lock:
                    self._inflight[kind] -= 1

    # ------------------------------------------------------------- consumer

    def get_next_batch(self, timeout: float = GET_TIMEOUT_S) -> Dict:
        """Strictly alternate labeled/unlabeled by parity (ref
        loader.py:140-146); drain built batches before surfacing an error.
        Raises TimeoutError after ``timeout`` seconds without the batch."""
        name = stream_for_batch(self._batch_parity, self.unlabeled is not None)
        self._batch_parity += 1
        self.served.append(name)
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._queues[name].get_nowait()
            except queue.Empty:
                pass
            if self._error is not None:
                raise RuntimeError("minibatch worker failed") from self._error
            if self._stop.is_set():
                raise RuntimeError("loader was shut down")
            _check_deadline(deadline, timeout, f"{name} batch")
            try:
                return self._queues[name].get(timeout=1.0)
            except queue.Empty:
                continue

    def queue_depth(self) -> int:
        return sum(q.qsize() for q in self._queues.values())

    def shutdown(self):
        self._stop.set()
        for _ in self._procs:
            try:
                self._task_q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        for q in self._queues.values():
            _drain(q)
        # drain the result pipe so workers blocked on put can exit
        try:
            while True:
                self._result_q.get_nowait()
        except (queue.Empty, EOFError, OSError):
            pass
        for p in self._procs:
            p.join(timeout=_SHUTDOWN_JOIN_S)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for t in (self._dispatcher, self._collector):
            if t.is_alive():
                t.join(timeout=_SHUTDOWN_JOIN_S)
        # batches built but never collected
        shutil.rmtree(self._spool_dir, ignore_errors=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
