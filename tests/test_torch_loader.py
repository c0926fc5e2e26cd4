"""The port's host feed against sad_tpu's: the per-stream draw and seed
schedule of ``_Stream`` and its fast-forward, TrainingLoader batch for batch
(one stream, and labeled + unlabeled alternating by parity) on a synthetic
COCO the port writes, the multi-process loader against the threaded one,
worker errors reaching the consumer, and DevicePrefetcher on the CPU
(order, errors, bounded shutdown).

Batches compare exactly except the bbox targets, within 1e-6: sad_tpu's
label assignment may take its float32 native pass, the port's is float64
(tests/test_torch_minibatch.py). Every wait here has a timeout."""

import io
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import sad_tpu.config as jcfg
import sad_tpu_torch.config as tcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data import loader as jloader
from sad_tpu.data.dataset import combined_roidb_for_training as j_roidb
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu_torch.data import loader as tloader
from sad_tpu_torch.data.dataset import combined_roidb_for_training as t_roidb
from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder
from sad_tpu_torch.data.mp_loader import MultiprocessTrainingLoader, spool_batch, unspool_batch
from sad_tpu_torch.data.rpn_minibatch import RCNNMinibatchBuilder
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)

CFG = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 9},
    "NUM_GPUS": 1,
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0), "SCALES_PER_OCTAVE": 2},
    "TRAIN": {"SCALES": (64, 96), "MAX_SIZE": 128, "IMS_PER_BATCH": 2},
    "PIXEL_STD": (57.375, 57.12, 58.395),
}
GET_S = 60.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Labeled and 'pseudo-labeled' splits, registered in both catalogs,
    with landscape and portrait images; their roidbs from each package."""
    root = str(tmp_path_factory.mktemp("loader_ds"))
    names = {}
    for split, seed, n in (("lab", 3, 9), ("pl", 4, 7)):
        img_dir, js = generate_synthetic_coco(root, split, n, seed=seed, size_range=(48, 96),
                                              objects_per_image=(1, 3), small_frac=0.0)
        name = f"torch_loader_{split}"
        jcfg.register_dataset(name, img_dir, js, allow_override=True)
        tcfg.register_dataset(name, img_dir, js, is_pseudo_labeled=split == "pl",
                              allow_override=True)
        names[split] = name
    out = {}
    for key, fn in (("j", j_roidb), ("t", t_roidb)):
        out[key] = (fn([names["lab"]], True), fn([names["pl"]], True))
    assert len(out["t"][0]) == len(out["j"][0]) > 8
    return out


def _cfgs():
    return j_merge(jcfg.Config(), CFG), t_merge(tcfg.Config(), CFG)


def _assert_batch_equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if isinstance(j[k], dict):
            assert sorted(t[k]) == sorted(j[k])
            for lvl in j[k]:
                if k == "bbox_targets":
                    np.testing.assert_allclose(t[k][lvl], j[k][lvl], rtol=0, atol=1e-6)
                else:
                    np.testing.assert_array_equal(t[k][lvl], j[k][lvl], err_msg=f"{k}[{lvl}]")
        else:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


@pytest.mark.parametrize("skip", [0, 5])
def test_stream_draws_seeds_and_fast_forward_match(data, skip):
    (jl, ju), (tl, tu) = data["j"], data["t"]
    js = jloader._Stream(jl, 3, 7), jloader._Stream(ju, 3, 8)
    ts = tloader._Stream(tl, 3, 7), tloader._Stream(tu, 3, 8)
    jloader.fast_forward_streams(*js, skip)
    tloader.fast_forward_streams(*ts, skip)
    assert [s.count for s in ts] == [s.count for s in js] == [(skip + 1) // 2, skip // 2]
    for _ in range(9):  # past an epoch of each pool
        for a, b in zip(ts, js):
            assert a.next_batch_indices_seeded() == b.next_batch_indices_seeded()
    one_j, one_t = jloader._Stream(jl, 2, 5), tloader._Stream(tl, 2, 5)
    jloader.fast_forward_streams(one_j, None, skip)
    tloader.fast_forward_streams(one_t, None, skip)
    assert one_t.count == one_j.count == skip
    assert one_t.next_batch_indices_seeded() == one_j.next_batch_indices_seeded()


@pytest.mark.parametrize("streams", ["labeled", "labeled+unlabeled"])
def test_training_loader_matches_sad_tpu(data, streams):
    jc, tc = _cfgs()
    two = streams != "labeled"
    j = jloader.TrainingLoader(jc, data["j"][0], unlabeled_roidb=data["j"][1] if two else None,
                               num_threads=3, skip_batches=1).start()
    t = tloader.TrainingLoader(tc, data["t"][0], unlabeled_roidb=data["t"][1] if two else None,
                               num_threads=3, skip_batches=1).start()
    try:
        for _ in range(6):
            _assert_batch_equal(t.get_next_batch(timeout=GET_S), j.get_next_batch())
    finally:
        j.shutdown()
        t.shutdown()
    want = [tloader.stream_for_batch(i, two) for i in range(1, 7)]
    assert t.served == want
    assert len(t.build_seconds) >= 6


def test_two_streams_alternate_by_parity(data):
    """Labeled on even batch numbers, unlabeled on odd ones, each stream's
    batches in its own draw order with its own seeds, whatever the thread
    count: every batch equals the one built from its stream's next draw."""
    _, tc = _cfgs()
    loader = tloader.TrainingLoader(tc, data["t"][0], unlabeled_roidb=data["t"][1],
                                    num_threads=4, queue_capacity=2).start(prefill=True)
    streams = {"labeled": tloader._Stream(data["t"][0], 2, 3),
               "unlabeled": tloader._Stream(data["t"][1], 2, 4)}
    try:
        for i in range(8):
            got = loader.get_next_batch(timeout=GET_S)
            s = streams["labeled" if i % 2 == 0 else "unlabeled"]
            idxs, seed, _ = s.next_batch_indices_seeded()
            want = loader.builder.build([s.roidb[k] for k in idxs], seed=seed).as_pytree()
            _assert_batch_equal(got, want)
    finally:
        loader.shutdown()
    assert loader.served == ["labeled", "unlabeled"] * 4


def _bad_roidb(roidb):
    bad = [dict(e) for e in roidb]
    for e in bad:
        e["image"] = e["image"] + ".missing"
    return bad


@pytest.mark.parametrize("kind", ["threads", "processes"])
def test_worker_error_reaches_the_consumer(data, kind):
    _, tc = _cfgs()
    cls = tloader.TrainingLoader if kind == "threads" else MultiprocessTrainingLoader
    kw = {"num_threads": 2} if kind == "threads" else {"num_workers": 2}
    loader = cls(tc, _bad_roidb(data["t"][0]), **kw).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="failed") as info:
            loader.get_next_batch(timeout=GET_S)
    finally:
        loader.shutdown()
    assert time.monotonic() - t0 < GET_S
    chain = f"{info.value!r} {info.value.__cause__!r}"
    assert "missing" in chain or "No such file" in chain or "FileNotFound" in chain


def test_get_times_out_when_nothing_comes(data):
    _, tc = _cfgs()
    loader = tloader.TrainingLoader(tc, data["t"][0], num_threads=0)  # no thread builds
    with pytest.raises(TimeoutError):
        loader.get_next_batch(timeout=0.3)
    loader.shutdown()


def test_multiprocess_loader_matches_threaded(data):
    _, tc = _cfgs()
    args = (tc, data["t"][0])
    kw = {"unlabeled_roidb": data["t"][1], "skip_batches": 3}
    mp_loader = MultiprocessTrainingLoader(*args, num_workers=2, **kw).start(prefill=True,
                                                                              timeout=120)
    th = tloader.TrainingLoader(*args, num_threads=2, **kw).start()
    try:
        for _ in range(5):
            _assert_batch_equal(mp_loader.get_next_batch(timeout=GET_S),
                                th.get_next_batch(timeout=GET_S))
        assert len(mp_loader.build_seconds) >= 5 and mp_loader.num_workers == 2
    finally:
        mp_loader.shutdown()
        th.shutdown()
    assert not any(p.is_alive() for p in mp_loader._procs)
    assert mp_loader.served == th.served == ["unlabeled", "labeled"] * 2 + ["unlabeled"]


class _Counting:
    """A loader that yields numbered batches, then fails at ``fail_at``."""

    def __init__(self, fail_at=None):
        self.i = 0
        self.fail_at = fail_at
        self.closed = threading.Event()

    def get_next_batch(self, timeout=None):
        if self.i == self.fail_at:
            raise ValueError("batch builder broke")
        self.i += 1
        return {"x": np.full((2, 3), self.i, np.int32), "lv": {3: np.arange(self.i)},
                "n": 7}

    def queue_depth(self):
        return 0

    def shutdown(self):
        self.closed.set()


def test_device_prefetcher_on_cpu_keeps_order_and_passes_errors():
    feed = tloader.DevicePrefetcher(_Counting(fail_at=5), "cpu")
    try:
        for i in range(1, 6):
            b = feed.get_next_batch(timeout=GET_S)
            assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
            assert int(b["x"][0, 0]) == i and b["lv"][3].tolist() == list(range(i))
            assert b["n"] == 7
        with pytest.raises(RuntimeError, match="prefetch failed") as info:
            feed.get_next_batch(timeout=GET_S)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        t0 = time.monotonic()
        feed.shutdown()
        assert time.monotonic() - t0 < 10
    assert feed._loader.closed.is_set() and not feed._thread.is_alive()
    assert len(feed.copy_seconds) == 5 and len(feed.gets) == 5


@pytest.mark.parametrize("family", ["retinanet", "mask_rcnn"])
def test_builders_sent_to_workers_hold_no_torch(family):
    """The multi-process loader pickles its builder into each spawned
    worker: it must carry numpy and Python values only, so that a worker
    never imports torch for it, let alone touches the card."""
    _, tc = _cfgs()
    if family == "retinanet":
        builder = RetinaNetMinibatchBuilder(tc, tc)
    else:
        rc = t_merge(tc, {"MODEL": {"TYPE": "generalized_rcnn", "FASTER_RCNN": True,
                                    "MASK_ON": True},
                          "FPN": {"MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
                                  "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6}})
        builder = RCNNMinibatchBuilder(rc, device_normalize=True)
    modules = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module.split(".")[0])
            return super().find_class(module, name)

    got = Recording(io.BytesIO(pickle.dumps(builder))).load()
    assert type(got) is type(builder)
    assert "sad_tpu_torch" in modules and not modules & {"torch", "jax", "sad_tpu"}, modules


def test_spool_file_round_trip(tmp_path):
    """The multi-process loader's transfer: a batch written into one file
    and read back is the same batch (dtypes, shapes, values, plain numbers,
    empty arrays, non-contiguous inputs), and the file is gone after."""
    rng = np.random.RandomState(0)
    batch = {"data_u8": rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8),
             "labels": {3: rng.randint(-1, 9, (2, 4, 6, 9)).astype(np.int32),
                        4: np.zeros((2, 0, 3, 9), np.int32)},
             "fg_mask": {3: rng.uniform(size=(2, 4, 6, 9)) < 0.3},
             "bbox_targets": {3: rng.randn(2, 6, 4, 9, 4).astype(np.float32).transpose(
                 0, 2, 1, 3, 4)},
             "gt_mask_stride": 4}
    path = str(tmp_path / "b.batch")
    layout = pickle.loads(pickle.dumps(spool_batch(batch, path)))
    got = unspool_batch(path, layout)
    assert not (tmp_path / "b.batch").exists()
    _assert_batch_equal(got, batch)
    assert got["gt_mask_stride"] == 4
    for k in ("data_u8", "labels", "fg_mask", "bbox_targets"):
        a, b = (got[k], batch[k]) if k == "data_u8" else (got[k][3], batch[k][3])
        assert a.dtype == b.dtype and a.shape == b.shape
    assert got["labels"][4].shape == (2, 0, 3, 9)
