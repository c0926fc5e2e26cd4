"""Run inference on a directory of images and render detections
(ref: sad_tpu/tools/infer_simple.py; detectron/tools/infer_simple.py:93-135).

Usage:
  python -m sad_tpu_torch.tools.infer_simple --cfg cfg.yaml --weights model.pkl \
      --image-dir imgs/ --output-dir out/ [--thresh 0.5] [--device cuda]

--weights is a native sad_tpu checkpoint pickle; without weights the model
keeps its seeded random initialisation.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.convert import load_checkpoint_params, load_params
from sad_tpu_torch.device import get_device
from sad_tpu_torch.eval.inference import make_inference_fn
from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
from sad_tpu_torch.models.model_builder import compute_dtype, create_model

logger = logging.getLogger("infer_simple")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    # --wts is the reference's name for the same flag
    p.add_argument("--weights", "--wts", dest="weights", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--ext", "--image-ext", dest="ext", default="jpg")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    # the reference takes a positional image-or-folder operand
    p.add_argument("im_or_folder", nargs="?", default=None)
    args = p.parse_args(argv)
    if args.image_dir is None:
        if args.im_or_folder is None:
            p.error("provide --image-dir or an im_or_folder operand")
        args.image_dir = args.im_or_folder
    logging.basicConfig(level=logging.INFO)

    from PIL import Image

    from sad_tpu_torch.data.minibatch import compute_im_scale, resize_bgr_u8
    from sad_tpu_torch.utils.vis import vis_one_image

    cfg = load_cfg(args.cfg_file)
    dev = get_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = create_model(cfg, dev, gen)
    weights = args.weights or cfg.TEST.WEIGHTS
    if weights:
        load_params(model, load_checkpoint_params(weights))
    model.to(compute_dtype(cfg))
    infer = make_inference_fn(cfg, model)
    land, port = _test_canvas_shapes(cfg)
    os.makedirs(args.output_dir, exist_ok=True)

    paths = (
        [args.image_dir]
        if os.path.isfile(args.image_dir)
        else sorted(glob.glob(os.path.join(args.image_dir, f"*.{args.ext}")))
    )
    for path in paths:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        bgr = rgb[:, :, ::-1].copy()
        ih, iw = bgr.shape[:2]
        ch, cw = land if iw >= ih else port
        scale = compute_im_scale(ih, iw, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
        im = resize_bgr_u8(bgr, scale)
        data = np.zeros((1, ch, cw, 3), np.uint8)
        data[0, :im.shape[0], :im.shape[1]] = im
        out = infer(
            torch.from_numpy(data).to(dev),
            torch.tensor([[ih, iw]], dtype=torch.float32, device=dev),
            torch.tensor([scale], dtype=torch.float32, device=dev),
            torch.tensor([im.shape[:2]], dtype=torch.float32, device=dev),
        )
        boxes, scores, classes, valid = (
            out[k][0].cpu().numpy() for k in ("boxes", "scores", "classes", "valid"))
        out_path = os.path.join(
            args.output_dir, os.path.basename(path).rsplit(".", 1)[0] + "_det.png"
        )
        vis_one_image(rgb, boxes, scores, classes, valid, thresh=args.thresh,
                      out_path=out_path)
        logger.info("%s: %d detections -> %s", path, int(valid.sum()), out_path)


if __name__ == "__main__":
    main()
