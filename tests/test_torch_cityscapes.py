"""Cityscapes on the CPU: the gtFine converter
(tools/convert_cityscapes_to_coco.py), the result export
(eval/cityscapes_eval.py) and test_net on the converted split, each against
sad_tpu's counterpart on the same seeded tree (data/synth_devkits: 3 images
at 128x64, polygons of the 8 instance classes, a crowd region, a 'sky'
region and a degenerate polygon an image).

- The converter's json: byte-equal to sad_tpu's, crowd, 'sky' and
  degenerate polygons skipped.
- The export of the same detections (the ground truth as detections, RLE
  masks): every pred.txt and PNG byte-equal to sad_tpu's.
- test_net --device cpu with a tiny Mask R-CNN on the converted split under a
  ``cityscapes_`` name against sad_tpu's test_net_on_dataset: detections
  within the tolerances of tests/test_torch_test_net.py, the 24 bbox and
  segm metrics within 1e-6, the same manifests (scores within 1e-4) and PNGs.
"""

import json
import os

import numpy as np
import pytest

import sad_tpu.config as jcfg
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.eval import cityscapes_eval as j_cs
from sad_tpu.models import create_model as j_create_model
from sad_tpu.tools import convert_cityscapes_to_coco as j_convert
from sad_tpu_torch.data.synth_devkits import write_cityscapes_tree
from sad_tpu_torch.eval import cityscapes_eval
from sad_tpu_torch.tools import convert_cityscapes_to_coco
from sad_tpu_torch.utils.segms import mask_to_rle, polys_to_mask
from test_torch_models import one_torch_thread, sad_tpu_native_loaded  # noqa: F401  (autouse)
from test_torch_rcnn import rcnn_params
from test_torch_test_net import BBOX_KEYS, MASK, _matched, _read, _register, _run_pair

CS_NAME = "cityscapes_fine_instanceonly_seg_torchcs"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    img_dir, _ = write_cityscapes_tree(root, "val", 3, seed=2, hw=(64, 128))
    out = str(tmp_path_factory.mktemp("cs_json"))
    js = convert_cityscapes_to_coco.convert_cityscapes_instance_only(root, out, ["gtFine_val"])
    return root, img_dir, js["gtFine_val"]


def _files(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                out[os.path.relpath(os.path.join(base, f), d)] = fh.read()
    return out


def test_converter_json_equals_sad_tpus(tree, tmp_path):
    root, _, js = tree
    ref = j_convert.convert_cityscapes_instance_only(root, str(tmp_path), ["gtFine_val"])
    with open(ref["gtFine_val"], "rb") as a, open(js, "rb") as b:
        assert a.read() == b.read()
    doc = json.load(open(js))
    assert len(doc["images"]) == 3
    src = [json.load(open(os.path.join(root, "gtFine_trainvaltest", "gtFine", "val",
                                       "frankfurt", f)))
           for f in sorted(os.listdir(os.path.join(root, "gtFine_trainvaltest", "gtFine", "val",
                                                   "frankfurt")))]
    # every object but the sky, the crowd region and the degenerate polygon
    assert len(doc["annotations"]) == sum(len(s["objects"]) - 3 for s in src)
    assert {c["name"] for c in doc["categories"]} <= set(cityscapes_eval.CITYSCAPES_NAME_TO_LABEL_ID)


def _gt_dets(doc):
    hw = {im["id"]: (im["height"], im["width"]) for im in doc["images"]}
    return [{"image_id": a["image_id"], "category_id": a["category_id"], "score": 0.5 + 0.01 * i,
             "bbox": a["bbox"],
             "segmentation": mask_to_rle(polys_to_mask(a["segmentation"], *hw[a["image_id"]]))}
            for i, a in enumerate(doc["annotations"])]


def test_export_is_byte_equal_to_sad_tpus(tree, tmp_path):
    _, img_dir, js = tree
    doc = json.load(open(js))
    roidb = [{"id": im["id"], "image": os.path.join(img_dir, im["file_name"])}
             for im in doc["images"]]
    names = {c["id"]: c["name"] for c in doc["categories"]}
    dets = _gt_dets(doc)
    j_cs.export_cityscapes_results(roidb, dets, names, str(tmp_path / "jax"))
    cityscapes_eval.export_cityscapes_results(roidb, dets, names, str(tmp_path / "torch"))
    ref, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(got) == sorted(ref) and got == ref
    assert sum(f.endswith(".png") for f in got) == len(dets)
    assert sum(f.endswith("pred.txt") for f in got) == 3
    # without cityscapesscripts the evaluation exports, warns and returns None
    assert cityscapes_eval.evaluate_masks(roidb, dets, names, str(tmp_path / "eval")) is None
    assert _files(tmp_path / "eval") == got


@pytest.fixture(scope="module")
def cs_pair(tree, tmp_path_factory):
    _, img_dir, js = tree
    _register(CS_NAME, img_dir, js)
    over = dict(MASK, TEST=dict(MASK["TEST"], DATASETS=(CS_NAME,)))
    params = rcnn_params(j_create_model(j_merge(jcfg.Config(), MASK)), seed=21)
    logits = params["mask_head"]["mask_fcn_logits"]
    logits["kernel"] = logits["kernel"] * 20.0
    return _run_pair(tmp_path_factory.mktemp("cs_test_net"), over, params)


def test_test_net_on_the_converted_split_matches_sad_tpu(cs_pair):
    ref_dir, got_dir, _, _ = cs_pair
    ref, got = _read(ref_dir, "bbox_results.json"), _read(got_dir, "bbox_results.json")
    _matched(ref, got)
    rr, rg = _read(ref_dir, "results.json"), _read(got_dir, "results.json")
    keys = BBOX_KEYS + tuple(f"segm_{k}" for k in BBOX_KEYS)
    assert sorted(rg) == sorted(rr) == sorted(keys)
    for k in keys:
        assert abs(rg[k] - rr[k]) <= 1e-6, (k, rg[k], rr[k])
    ref_f = {k: v for k, v in _files(ref_dir).items() if k.endswith((".png", "pred.txt"))}
    got_f = {k: v for k, v in _files(got_dir).items() if k.endswith((".png", "pred.txt"))}
    assert sorted(got_f) == sorted(ref_f)
    assert sum(k.endswith(".png") for k in got_f) == len(got) > 0
    for k in ref_f:
        if k.endswith(".png"):
            assert got_f[k] == ref_f[k], k
            continue
        for a, b in zip(ref_f[k].decode().splitlines(), got_f[k].decode().splitlines(),
                        strict=True):
            (pa, la, sa), (pb, lb, sb) = a.split(), b.split()
            assert (pa, la) == (pb, lb) and abs(float(sa) - float(sb)) <= 1e-4
    assert np.isfinite(list(rg.values())).all()
    assert _read(got_dir, "timing.json")["export_cityscapes"] > 0
