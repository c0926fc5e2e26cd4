"""The port's native host kernels (sad_tpu_torch/native) against sad_tpu's
(sad_tpu/native), and against their numpy float32 twins (native/plain.py):
the IoU matrix, the fused assignment pass, greedy NMS and soft-NMS are
bit-equal on seeded boxes; the build raises where g++ is missing or fails,
and processes that load at once share one build."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sad_tpu.data.anchors as janchors
import sad_tpu.native as jnative
import sad_tpu_torch.native as tnative
from sad_tpu_torch.native.plain import assign_overlaps_plain, bbox_overlaps_plain
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
GRID = janchors.all_field_anchors((3, 4, 5, 6, 7), 4.0, (1.0, 2.0, 0.5), 3, 256, 384)


def gt_boxes(rng, k, h=256, w=384, scale=None):
    """k boxes on integer pixels of an image, scaled to the canvas as the
    minibatch builder does (ties between anchors come from such grids)."""
    s = rng.uniform(0.5, 1.7) if scale is None else scale
    hh, ww = int(h / s), int(w / s)
    x1, y1 = rng.randint(0, ww - 12, k), rng.randint(0, hh - 12, k)
    x2 = np.minimum(x1 + rng.randint(6, ww // 2, k), ww - 1)
    y2 = np.minimum(y1 + rng.randint(6, hh // 2, k), hh - 1)
    return (np.stack([x1, y1, x2, y2], 1) * s).astype(np.float32)


def dets(rng, n, clusters=6):
    """(n, 5) boxes in clusters (heavy overlap), scores with repeats."""
    c = rng.uniform(0, 300, (clusters, 2))[rng.randint(0, clusters, n)]
    wh = rng.uniform(10, 60, (n, 2))
    xy = c + rng.normal(0, 8, (n, 2))
    score = np.round(rng.uniform(0, 1, (n, 1)), 2)
    return np.concatenate([xy, xy + wh, score], 1).astype(np.float32)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_assignment_bit_equal_to_sad_tpu_and_twin(seed):
    rng = np.random.RandomState(seed)
    flat = GRID.flat_anchors()
    for k in (1, 3, 8, 20):
        gt = gt_boxes(rng, k)
        got = tnative.assign_overlaps(flat, gt)
        for a, b, c in zip(got, jnative.assign_overlaps(flat, gt),
                           assign_overlaps_plain(flat, gt)):
            same(a, b)
            same(a, c)
        iou = tnative.bbox_overlaps(flat, gt)
        same(iou, jnative.bbox_overlaps(flat, gt))
        same(iou, bbox_overlaps_plain(flat, gt))
        assert iou.dtype == np.float32 and (iou > 0).any()


def test_assignment_tie_rules():
    """A gt's best overlap ties on every anchor that reaches it; a gt that
    overlaps nothing has best overlap 0, so every anchor off it ties; the
    per-anchor argmax is the first of equal maxima."""
    anchors = np.array([[0, 0, 9, 9], [10, 0, 19, 9], [0, 10, 9, 19], [50, 50, 59, 59]],
                       np.float32)
    gt = np.array([[0, 0, 19, 9], [0, 0, 19, 9]], np.float32)  # two equal gts
    a2g_max, arg, tie = tnative.assign_overlaps(anchors, gt)
    same(a2g_max, np.array([0.5, 0.5, 0.0, 0.0], np.float32))
    same(arg, np.zeros(4, np.int64))
    same(tie, np.array([True, True, False, False]))
    far = np.array([[200, 200, 210, 210]], np.float32)
    _, _, tie = tnative.assign_overlaps(anchors, far)
    same(tie, np.ones(4, bool))
    for out, ref in zip(tnative.assign_overlaps(anchors, far), assign_overlaps_plain(anchors, far)):
        same(out, ref)


def test_empty_inputs():
    anchors = GRID.flat_anchors()[:10]
    for got, ref in zip(tnative.assign_overlaps(anchors, np.zeros((0, 4), np.float32)),
                        assign_overlaps_plain(anchors, np.zeros((0, 4), np.float32))):
        same(got, ref)
    same(tnative.bbox_overlaps(np.zeros((0, 4)), anchors), np.zeros((0, 10), np.float32))
    same(tnative.nms(np.zeros((0, 5)), 0.5), jnative.nms(np.zeros((0, 5), np.float32), 0.5))
    with pytest.raises(ValueError, match=r"\(N, 4\)"):
        tnative.bbox_overlaps(np.zeros((3, 5)), anchors)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_bit_equal_to_sad_tpu(thresh):
    rng = np.random.RandomState(int(thresh * 10))
    for n in (1, 17, 300):
        d = dets(rng, n)
        keep = tnative.nms(d, thresh)
        same(keep, jnative.nms(d, thresh))
        assert 0 < len(keep) <= n


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_bit_equal_to_sad_tpu(method):
    rng = np.random.RandomState(len(method))
    for n in (1, 40, 200):
        d = dets(rng, n)
        got = tnative.soft_nms(d, 0.5, 0.3, 0.001, method)
        ref = jnative.soft_nms(d, 0.5, 0.3, 0.001, method)
        same(got[0], ref[0])
        same(got[1], ref[1])
    with pytest.raises(ValueError, match="method"):
        tnative.soft_nms(d, method="greedy")


def _fresh_build(monkeypatch, tmp_path, source=None):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    if source is not None:
        monkeypatch.setattr(tnative, "SOURCE", source)


def test_build_raises_without_gxx(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda _: None)
    with pytest.raises(tnative.NativeBuildError, match="g\\+\\+ not found"):
        tnative.bbox_overlaps(np.zeros((1, 4)), np.zeros((1, 4)))


def test_build_raises_on_compile_error(monkeypatch, tmp_path):
    bad = tmp_path / "host_kernels.cpp"
    bad.write_text("extern \"C\" void sad_bbox_overlaps( { }\n")
    _fresh_build(monkeypatch, tmp_path, bad)
    with pytest.raises(tnative.NativeBuildError, match="g\\+\\+ failed"):
        tnative.load()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_concurrent_processes_share_one_build(tmp_path):
    """Four processes load at once into an empty build directory: one
    compiles under the lock, all load the same library and agree."""
    code = (
        "import sys; from pathlib import Path; import numpy as np\n"
        "import sad_tpu_torch.native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "a = np.array([[0, 0, 9, 9], [5, 5, 14, 14]], np.float32)\n"
        "print(n.library_path().name, n.bbox_overlaps(a, a).tobytes().hex())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [outs[0][0].split()[0]]
    assert not list(tmp_path.glob("*.tmp"))
