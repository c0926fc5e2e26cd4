"""python -m sad_tpu_torch.tools.infer_simple on the CPU: a native sad_tpu
checkpoint pickle loads into the port, every image gets a rendering, and a
checkpoint of another architecture is refused."""

import pickle

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.convert import state_dict_to_params
from sad_tpu_torch.models import create_model
from sad_tpu_torch.tools.infer_simple import main
from test_torch_models import one_torch_thread  # noqa: F401  (autouse)

CFG = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 5,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 128},
    "RETINANET": {"RETINANET_ON": True, "ASPECT_RATIOS": (1.0,), "SCALES_PER_OCTAVE": 1,
                  "NUM_CONVS": 1},
    "TEST": {"SCALES": (96,), "MAX_SIZE": 160, "NMS": 0.5},
    "COMPUTE_DTYPE": "float32",
}


@pytest.fixture
def setup(tmp_path):
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(CFG))
    cfg = load_cfg(str(cfg_file))
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(3))
    ckpt = tmp_path / "model_final.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": state_dict_to_params(model.state_dict()), "velocity": None,
                     "iter": 0, "cfg_yaml": ""}, f)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(80, 120), (130, 70)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(img_dir / f"{i}.jpg")
    return cfg_file, ckpt, img_dir


def test_infer_simple_renders_every_image(setup, tmp_path):
    cfg_file, ckpt, img_dir = setup
    out = tmp_path / "out"
    main(["--cfg", str(cfg_file), "--weights", str(ckpt), "--image-dir", str(img_dir),
          "--output-dir", str(out), "--device", "cpu", "--thresh", "0.0"])
    assert sorted(p.name for p in out.iterdir()) == ["0_det.png", "1_det.png"]


def test_infer_simple_refuses_other_weights(setup, tmp_path):
    cfg_file, ckpt, img_dir = setup
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    payload["params"]["head"]["retnet_cls_pred_fpn3"]["bias"] = np.zeros(7, np.float32)
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="shape"):
        main(["--cfg", str(cfg_file), "--weights", str(bad), "--image-dir", str(img_dir),
              "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
