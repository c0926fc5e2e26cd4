"""The port's synthetic COCO generator (sad_tpu_torch/data/synth_coco.py)
writes the same json and the same pixels as sad_tpu's for a seed: labeled
(polygons, crowd RLE, ignore flags), with keypoints, and an unlabeled
image-info split. Exact: both draw from one RandomState in one order."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from sad_tpu.data.synth_coco import generate_synthetic_coco as j_generate
from sad_tpu_torch.data import synth_coco
from sad_tpu_torch.data.synth_coco import generate_synthetic_coco as t_generate
from test_torch_models import sad_tpu_native_loaded  # noqa: F401  (autouse)

CASES = {
    "labeled": {},
    "keypoints": {"with_keypoints": True},
    "unlabeled": {"labeled": False},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_json_and_pixels_as_sad_tpu(tmp_path, case):
    kw = dict(n_images=6, seed=11, size_range=(40, 72), crowd_frac=0.5, ignore_frac=0.3,
              **CASES[case])
    j_dir, j_json = j_generate(str(tmp_path / "j"), "s", **kw)
    t_dir, t_json = t_generate(str(tmp_path / "t"), "s", **kw)
    assert os.path.basename(t_json) == os.path.basename(j_json)
    assert os.path.basename(t_json).startswith("instances" if kw.get("labeled", True)
                                               else "image_info")
    with open(j_json) as f:
        jdoc = json.load(f)
    with open(t_json) as f:
        tdoc = json.load(f)
    assert tdoc == jdoc
    assert ("annotations" in tdoc) == kw.get("labeled", True)
    if case == "labeled":
        anns = tdoc["annotations"]
        assert any(a["iscrowd"] for a in anns) and any(a.get("ignore") for a in anns)
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir)) and len(os.listdir(t_dir)) == 6
    for name in os.listdir(j_dir):
        a = np.asarray(Image.open(os.path.join(j_dir, name)))
        b = np.asarray(Image.open(os.path.join(t_dir, name)))
        np.testing.assert_array_equal(a, b)


def test_cli_writes_a_split(tmp_path, capsys):
    assert synth_coco.main(["--output-dir", str(tmp_path), "--split", "u", "--num-images", "2",
                            "--unlabeled"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["json"].endswith("image_info_u.json") and len(os.listdir(out["image_dir"])) == 2
    with pytest.raises(ValueError, match="n_categories"):
        t_generate(str(tmp_path), "x", n_images=1, n_categories=9)
