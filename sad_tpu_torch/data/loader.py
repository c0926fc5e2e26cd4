"""Threaded host training data pipeline and the host -> card prefetcher.

A copy of sad_tpu/data/loader.py, with ``DevicePrefetcher`` rewritten for
CUDA. Capability-equivalent to detectron/lib/roi_data/loader.py
(RoIDataLoader + enqueue threads + Caffe2 BlobsQueue):

- loader threads build whole static-shape batches (RetinaNetMinibatchBuilder
  or RCNNMinibatchBuilder) into host queues,
- epoch shuffling with aspect grouping: landscape/portrait pools shuffled
  independently and batches drawn from one pool so every batch shares one
  canvas (ref: deque-rotation aspect grouping, loader.py:173-245),
- semi-supervised alternation: when an unlabeled roidb is present, batches
  strictly alternate labeled/unlabeled by batch parity (loader.py:140-146),
  and loader threads fill whichever stream is behind (loader.py:109-115),
- coordinator-style shutdown that drains threads on error or exit
  (lib/utils/coordinator.py:32-66),
- data parallelism: with ``rank`` / ``world``, every rank draws the same
  global schedule (seeds, reshuffles, stream parity, fast-forward) and
  builds only its contiguous block of each batch's images (``RankShard``):
  the ranks' blocks concatenate to the one-rank batch,
- ``DevicePrefetcher`` (the BlobsQueue analogue): a thread copies the next
  batch into pinned host memory and onto the card with ``non_blocking``
  copies on a side CUDA stream, while the current step runs.

Every wait has a timeout and shutdown is bounded.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from .minibatch import RetinaNetMinibatchBuilder

_SHUTDOWN_JOIN_S = 2.0
# the longest a consumer waits for one batch before it calls the feed hung
GET_TIMEOUT_S = 600.0


class _Stream:
    """Epoch-shuffled index stream with aspect grouping."""

    def __init__(self, roidb: List[dict], batch_images: int, seed: int):
        if not roidb:
            raise ValueError(
                "empty roidb — check TRAIN.DATASETS and the dataset catalog"
            )
        self.roidb = roidb
        self.batch_images = batch_images
        # Per-stream batch-seed schedule: the k-th batch drawn from THIS
        # stream always gets seed (seed*1_000_003 + k), paired atomically
        # with the index draw, so stream contents are a pure function of
        # (roidb, seed, k) whatever the labeled/unlabeled interleaving and
        # the queue timing; that is also what lets a resumed run
        # fast-forward to the exact batch sequence (skip()).
        self._seed = seed
        self.count = 0
        self.rng = np.random.RandomState(seed)
        self.landscape = [
            i for i, e in enumerate(roidb) if e["width"] >= e["height"]
        ]
        self.portrait = [
            i for i, e in enumerate(roidb) if e["width"] < e["height"]
        ]
        self._cursors = {}
        self._shuffled = {}
        self._lock = threading.Lock()
        for key in ("l", "p"):
            self._reshuffle(key)

    def _pool(self, key):
        return self.landscape if key == "l" else self.portrait

    def _reshuffle(self, key):
        pool = list(self._pool(key))
        self.rng.shuffle(pool)
        self._shuffled[key] = pool
        self._cursors[key] = 0

    def next_batch_indices(self) -> List[int]:
        return self.next_batch_indices_seeded()[0]

    def next_batch_indices_seeded(self) -> tuple:
        """(indices, batch_seed, seq) for the stream's next batch; the
        triple is drawn atomically so concurrent callers cannot mismatch
        draw, seed, and sequence position."""
        with self._lock:
            # prefer whichever orientation pool has more remaining
            keys = [k for k in ("l", "p") if len(self._pool(k)) >= 1]
            key = max(
                keys,
                key=lambda k: len(self._shuffled[k]) - self._cursors[k],
            )
            idxs = []
            while len(idxs) < self.batch_images:
                if self._cursors[key] >= len(self._shuffled[key]):
                    self._reshuffle(key)
                idxs.append(self._shuffled[key][self._cursors[key]])
                self._cursors[key] += 1
            seq = self.count
            bseed = (self._seed * 1_000_003 + seq) % (2 ** 31)
            self.count += 1
        return idxs, bseed, seq

    def next_batch(self) -> List[dict]:
        return [self.roidb[i] for i in self.next_batch_indices()]

    def skip(self, n: int) -> None:
        """Fast-forward n batch draws (resume support: a run resumed at iter
        k replays the identical batch sequence from k onward)."""
        for _ in range(n):
            self.next_batch_indices_seeded()


class RankShard:
    """A minibatch builder that builds only rank ``rank``'s share of each
    batch: the contiguous block of images (``rows`` of the wrapped builder's
    ``build``) of its data index, rank // n_model, over world / n_model data
    ranks; with ``n_model`` > 1 (a mesh's 'model' axis, parallel/mesh.py) only
    its band of rows of each canvas and of each level's targets, and the
    canvas height as ``canvas_h``. The batch's seed and per-image draws stay
    the whole batch's, and fg_num is taken over whole images: the ranks'
    bands, joined by rows, are the data shard's batch. A block that cuts a
    loss group carries its per-image fg counts (``fg_img``) in place of
    fg_num, which the mesh step adds into their groups over the ranks."""

    def __init__(self, builder, rank: int, world: int, n_model: int = 1):
        if n_model > 1 and not isinstance(builder, RetinaNetMinibatchBuilder):
            raise NotImplementedError(
                f"{type(builder).__name__} on a mesh with n_model > 1: height-sharded R-CNN "
                "batches are not ported; no sad_tpu path runs an R-CNN model under "
                "spatial_sharding (ROADMAP.md \"Not ported\", after item 7b)")
        self.builder, self.rank, self.world, self.n_model = builder, rank, world, n_model

    def canvas_for(self, entry: dict):
        return self.builder.canvas_for(entry)

    def build(self, entries: List[dict], seed: int = 0, **kwargs):
        n_data = self.world // self.n_model
        d = self.rank // self.n_model
        k = len(entries) // n_data
        built = self.builder.build(entries, seed=seed, rows=(d * k, (d + 1) * k), **kwargs)
        if self.n_model == 1:
            return built
        from ..parallel.mesh import row_band

        def band(x):
            if x is None:
                return None
            r0, r1 = row_band(x.shape[1], self.n_model, self.rank % self.n_model)
            return x[:, r0:r1]

        canvas = built.data_u8 if built.data_u8 is not None else built.data
        return dataclasses.replace(
            built, data=band(built.data), teacher_data=band(built.teacher_data),
            data_u8=band(built.data_u8), canvas_h=int(canvas.shape[1]),
            labels={lvl: band(x) for lvl, x in built.labels.items()},
            bbox_targets={lvl: band(x) for lvl, x in built.bbox_targets.items()},
            fg_mask={lvl: band(x) for lvl, x in built.fg_mask.items()})


def rank_builder(builder, batch_images: int, rank: int, world: int, n_model: int = 1):
    """``builder`` itself at world 1, else its RankShard; the batch must
    split into whole blocks over the world / n_model data ranks."""
    if world == 1:
        return builder
    n_data = world // n_model
    if n_data * n_model != world or batch_images % n_data:
        raise ValueError(f"a batch of {batch_images} images does not split over "
                         f"{world // max(n_model, 1)} x {n_model} ranks")
    return RankShard(builder, rank, world, n_model)


def fast_forward_streams(labeled, unlabeled, skip_batches: int) -> None:
    """Advance stream draws to position `skip_batches` of the CONSUMED
    sequence (resume support). With an unlabeled stream the consumer
    alternates by parity — labeled on even batches — so the labeled stream
    has supplied ceil(k/2) batches and the unlabeled floor(k/2)."""
    if unlabeled is not None:
        labeled.skip((skip_batches + 1) // 2)
        unlabeled.skip(skip_batches // 2)
    else:
        labeled.skip(skip_batches)


def stream_for_batch(parity: int, two_streams: bool) -> str:
    """The stream of the consumer's batch number ``parity``: labeled on
    even batches, unlabeled on odd ones when there are two."""
    return "unlabeled" if two_streams and parity % 2 else "labeled"


class TrainingLoader:
    """Prefetching loader; get_next_batch() yields host batches (dicts of
    numpy arrays). ``build_seconds`` holds (stream, host seconds) of every
    batch built, ``served`` the stream of every batch handed out. With
    ``world`` > 1 each batch holds rank ``rank``'s block of
    ``batch_images`` / world images."""

    def __init__(
        self,
        cfg: Config,
        roidb: List[dict],
        teacher_cfg: Optional[Config] = None,
        unlabeled_roidb: Optional[List[dict]] = None,
        batch_images: int = None,
        num_threads: int = 2,
        queue_capacity: int = 4,
        seed: int = 3,
        builder=None,
        skip_batches: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        self.cfg = cfg
        self.batch_images = batch_images or (cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS)
        # builder: any object with canvas_for(entry) + build(entries) —
        # RetinaNetMinibatchBuilder by default; RCNNMinibatchBuilder for the
        # Faster/Mask R-CNN path (data/rpn_minibatch.py)
        self.builder = rank_builder(builder or RetinaNetMinibatchBuilder(cfg, teacher_cfg),
                                    self.batch_images, rank, world)
        self.labeled = _Stream(roidb, self.batch_images, seed)
        self.unlabeled = (
            _Stream(unlabeled_roidb, self.batch_images, seed + 1)
            if unlabeled_roidb
            else None
        )
        self._seed = seed
        # UNBOUNDED queues + a claim-side capacity bound (below). Bounded
        # queues deadlocked (sad_tpu, round 4): every worker blocked
        # put()ing to the FULL labeled queue while the consumer's parity
        # wanted an unlabeled batch no one was building. With the bound
        # enforced at claim time instead, a worker never blocks holding a
        # built batch, and the wanted stream is always either already built
        # (backlog == cap implies its next seq is among the unconsumed) or
        # claimable (backlog < cap).
        self._queues = {"labeled": queue.Queue()}
        if self.unlabeled:
            self._queues["unlabeled"] = queue.Queue()
        self._capacity = queue_capacity
        self._inflight = {"labeled": 0}
        if self.unlabeled:
            self._inflight["unlabeled"] = 0
        self._backlog_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.num_workers = num_threads
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"loader{i}")
            for i in range(num_threads)
        ]
        self._batch_parity = 0
        self.build_seconds: List[Tuple[str, float]] = []
        self.served: List[str] = []
        # order restoration (same design as mp_loader): builds complete in
        # thread order, but the consumer surfaces them in DRAW order, so the
        # batch stream is deterministic for any num_threads
        self._next_seq = {"labeled": 0}
        self._pending: Dict[str, Dict[int, Dict]] = {"labeled": {}}
        if self.unlabeled:
            self._next_seq["unlabeled"] = 0
            self._pending["unlabeled"] = {}
        if skip_batches:
            fast_forward_streams(
                self.labeled, self.unlabeled, skip_batches
            )
            self._batch_parity = skip_batches
            self._next_seq["labeled"] = self.labeled.count
            if self.unlabeled:
                self._next_seq["unlabeled"] = self.unlabeled.count

    # ------------------------------------------------------------- threads

    def start(self, prefill: bool = False, timeout: float = 600.0):
        for t in self._threads:
            t.start()
        if prefill:
            target = self._capacity * len(self._queues)
            _wait_until(lambda: self.queue_depth() >= target or self._error is not None,
                        timeout, "loader prefill")
        return self

    def _claim_stream(self) -> Optional[str]:
        """Next stream to build: smallest backlog (queued + in flight +
        consumer-held out-of-order) below capacity; None = everything full
        (loader.py:109-115 semantics with the capacity bound moved from
        put() to the claim, which is what makes the two-stream pipeline
        deadlock-free)."""
        with self._backlog_lock:
            backlog = {
                n: self._queues[n].qsize() + self._inflight[n]
                + len(self._pending[n])
                for n in self._queues
            }
            candidates = [
                n for n, b in backlog.items() if b < self._capacity + 1
            ]
            if not candidates:
                return None
            name = min(candidates, key=backlog.get)
            self._inflight[name] += 1
            return name

    def _worker(self):
        try:
            while not self._stop.is_set():
                name = self._claim_stream()
                if name is None:
                    time.sleep(0.01)
                    continue
                stream = self.labeled if name == "labeled" else self.unlabeled
                # distinct deterministic seed per built batch (drives the
                # per-image scale sampling + RPN label subsampling); drawn
                # from the PER-STREAM schedule (see _Stream.__init__)
                idxs, bseed, seq = stream.next_batch_indices_seeded()
                entries = [stream.roidb[i] for i in idxs]
                t0 = time.perf_counter()
                built = self.builder.build(entries, seed=bseed)
                batch = built.as_pytree() if hasattr(built, "as_pytree") else built
                self.build_seconds.append((name, time.perf_counter() - t0))
                # unbounded put: never blocks, releases the claim atomically
                self._queues[name].put((seq, batch))
                with self._backlog_lock:
                    self._inflight[name] -= 1
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._error = e
            self._stop.set()

    # ------------------------------------------------------------- consumer

    def get_next_batch(self, timeout: float = GET_TIMEOUT_S) -> Dict:
        """Strictly alternate labeled/unlabeled by parity (loader.py:140-146);
        surface batches in draw order (consumer-side reordering). Raises
        TimeoutError after ``timeout`` seconds without the batch."""
        if self._error is not None:
            raise RuntimeError("loader thread failed") from self._error
        name = stream_for_batch(self._batch_parity, self.unlabeled is not None)
        self._batch_parity += 1
        self.served.append(name)
        want = self._next_seq[name]
        deadline = time.monotonic() + timeout
        while True:
            if want in self._pending[name]:
                self._next_seq[name] = want + 1
                return self._pending[name].pop(want)
            if self._error is not None:
                raise RuntimeError("loader thread failed") from self._error
            if self._stop.is_set():
                raise RuntimeError("loader was shut down")
            _check_deadline(deadline, timeout, f"{name} batch")
            try:
                seq, batch = self._queues[name].get(timeout=1.0)
            except queue.Empty:
                continue
            self._pending[name][seq] = batch

    def queue_depth(self) -> int:
        return sum(q.qsize() for q in self._queues.values()) + sum(
            len(p) for p in self._pending.values()
        )

    def shutdown(self):
        self._stop.set()
        for q in self._queues.values():
            _drain(q)
        for t in self._threads:
            t.join(timeout=_SHUTDOWN_JOIN_S)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()


def _drain(q) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _check_deadline(deadline: float, timeout: float, what: str) -> None:
    if time.monotonic() > deadline:
        raise TimeoutError(f"no {what} after {timeout:.0f} s")


def _wait_until(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not done after {timeout:.0f} s")
        time.sleep(0.05)


# --------------------------------------------------------------------------- #
# Host -> device
# --------------------------------------------------------------------------- #


def _map_arrays(batch, fn):
    """Apply fn to every array of a batch (nested level dicts kept, plain
    numbers passed through)."""
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    if isinstance(batch, (int, float)):
        return batch
    return fn(batch)


def _tensors(batch) -> list:
    out = []
    _map_arrays(batch, lambda t: out.append(t) or t)
    return out


class DevicePrefetcher:
    """Host->device double buffering — the BlobsQueue equivalent (ref:
    loader.py:250-273 enqueue threads + caffe2 queue ops): a thread takes
    the NEXT host batch and puts it on ``device`` while the current step
    runs.

    On a CUDA device the thread (which selects the card itself: the current
    device and stream are per thread) copies each array into pinned host
    memory and onto the card with ``non_blocking=True`` on its own side
    stream, records an event there, and waits on that event before it
    queues the batch: the pinned buffers are released only once their copy
    has ended. ``get_next_batch`` makes the caller's current stream wait on
    the event and marks every tensor as used on that stream
    (``record_stream``), so the caching allocator does not hand the memory
    to the side stream while the step still reads it. On the CPU a batch is
    ``torch.from_numpy`` of each array.

    Wraps any object with get_next_batch()/queue_depth()/shutdown().
    Measures ``copy_seconds`` (host time from a batch's arrival to the end
    of its copy) and, for each get, ``gets`` = (found no batch ready,
    seconds it blocked, queue depth of this queue and the loader's).
    """

    def __init__(self, loader, device, depth: int = 2):
        import torch

        self._loader = loader
        self._device = torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # the caller's current card: the prefetch thread selects it by index
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.copy_seconds: List[float] = []
        self.gets: List[Tuple[bool, float, int]] = []
        self._thread = threading.Thread(target=self._run, daemon=True, name="device-prefetch")
        self._thread.start()

    def _to_device(self, batch, stream):
        """(device batch, event or None)."""
        import torch

        if self._device.type != "cuda":
            return _map_arrays(batch, lambda a: torch.from_numpy(np.ascontiguousarray(a))), None
        with torch.cuda.stream(stream):
            dev = _map_arrays(batch, lambda a: torch.from_numpy(np.ascontiguousarray(a))
                              .pin_memory().to(self._device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        # the pinned buffers die with this frame: release them only after the copy
        event.synchronize()
        return dev, event

    def _run(self):
        import torch

        try:
            stream = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            while not self._stop.is_set():
                batch = self._loader.get_next_batch()
                t0 = time.perf_counter()
                item = self._to_device(batch, stream)
                self.copy_seconds.append(time.perf_counter() - t0)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._error = e
            self._stop.set()

    def _ready(self, item):
        import torch

        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(cur)
        return batch

    def get_next_batch(self, timeout: float = GET_TIMEOUT_S) -> Dict[str, Any]:
        depth = self.queue_depth()
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout
        empty = False
        # drain already-prefetched good batches before surfacing a worker
        # error (the error belongs to a LATER batch)
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            empty = True
            while True:
                if self._error is not None:
                    raise RuntimeError("device prefetch failed") from self._error
                _check_deadline(deadline, timeout, "prefetched batch")
                try:
                    item = self._q.get(timeout=1.0)
                    break
                except queue.Empty:
                    continue
        self.gets.append((empty, time.perf_counter() - t0, depth))
        return self._ready(item)

    def queue_depth(self) -> int:
        return self._loader.queue_depth() + self._q.qsize()

    def shutdown(self):
        self._stop.set()
        # the loader first: a prefetch thread blocked on it then returns
        self._loader.shutdown()
        _drain(self._q)
        self._thread.join(timeout=_SHUTDOWN_JOIN_S)
