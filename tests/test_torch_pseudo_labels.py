"""The teacher's pseudo-label writer: the port's generate_pseudo_labels
against sad_tpu's on a synthetic COCO set (landscape and portrait images,
a batch that needs padding) with the same converted float32 tiny weights.
The JSON must have the same images and categories, and annotations that
agree in image, category and id, with scores within 1e-5 and boxes within
1e-3 px."""

import dataclasses
import json

import numpy as np
import pytest

import __graft_entry__ as graft
import sad_tpu.config as jcfg
from sad_tpu.config import register_dataset
from sad_tpu.config.config import merge_cfg_from_dict as j_merge
from sad_tpu.data.synth_coco import generate_synthetic_coco
from sad_tpu.eval.test_engine import generate_pseudo_labels as j_generate
import sad_tpu_torch.config as tcfg
from sad_tpu_torch.config.config import merge_cfg_from_dict as t_merge
from sad_tpu.models import RetinaNet as JaxRetinaNet
from sad_tpu_torch.convert import load_params
from test_torch_models import random_params
from sad_tpu_torch.eval.test_engine import generate_pseudo_labels
from sad_tpu_torch.models import RetinaNet
from sad_tpu_torch.models.arch import ModelArch

DATASET = "torch_pseudo_synth_unlabel"
CFG = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 9},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0, 2.0, 0.5),
                  "SCALES_PER_OCTAVE": 3},
    "TEST": {"SCALES": (128,), "MAX_SIZE": 256, "NMS": 0.5, "DATASETS": (DATASET,)},
    "PIXEL_STD": (57.375, 57.12, 58.395),
    "COMPUTE_DTYPE": "float32",
}


@pytest.fixture(scope="module")
def both_jsons(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pseudo")
    img_dir, info_json = generate_synthetic_coco(
        str(root), split="unlabel", n_images=5, seed=11, size_range=(80, 200),
        objects_per_image=(1, 3), labeled=False,
    )
    register_dataset(DATASET, img_dir, info_json, allow_override=True)
    tcfg.register_dataset(DATASET, img_dir, info_json, allow_override=True)
    arch = graft._tiny_arch(num_classes=9)
    jmodel = JaxRetinaNet(arch)
    params = random_params(jmodel, np.zeros((1, 128, 256, 3), np.float32), seed=4)
    port = load_params(RetinaNet(ModelArch(**dataclasses.asdict(arch))).eval(), params)

    ref_path, got_path = str(root / "jax.json"), str(root / "torch.json")
    j_generate(j_merge(jcfg.Config(), CFG), jmodel, params, DATASET, ref_path,
               score_thresh=0.3, batch_size=2)
    generate_pseudo_labels(t_merge(tcfg.Config(), CFG), port, DATASET, got_path,
                           score_thresh=0.3, batch_size=2)
    with open(ref_path) as f:
        ref = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    return ref, got


def test_same_images_and_categories(both_jsons):
    ref, got = both_jsons
    assert got["images"] == ref["images"] and len(got["images"]) == 5
    assert got["categories"] == ref["categories"]
    hw = {(im["height"] >= im["width"]) for im in got["images"]}
    assert hw == {True, False}  # both canvas orientations ran


def test_same_annotations(both_jsons):
    ref, got = both_jsons
    assert len(got["annotations"]) == len(ref["annotations"]) > 0
    key = lambda a: (a["image_id"], a["category_id"], -a["score"])  # noqa: E731
    for a, b in zip(sorted(ref["annotations"], key=key), sorted(got["annotations"], key=key)):
        for field in ("id", "image_id", "category_id", "iscrowd"):
            assert a[field] == b[field], field
        assert abs(a["score"] - b["score"]) <= 1e-5
        assert a["score"] >= 0.3 and b["score"] >= 0.3
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0, atol=1e-3)
        assert abs(a["area"] - b["area"]) <= 1e-3 * (a["bbox"][2] + a["bbox"][3] + 1)
