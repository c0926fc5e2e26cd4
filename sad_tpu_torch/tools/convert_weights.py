"""Convert checkpoints between the port's native format and the reference's
Caffe2 blob pickles (ref: sad_tpu/tools/convert_weights.py).

The reference converted Caffe protobuf weights into Caffe2 blob pickles
(tools/pickle_caffe_blobs.py, utils/model_convert_utils.py); those pickles
are the published-weights format, which the port also loads directly
(train/checkpoint.load_reference_or_native). This tool goes both ways
between a blob pickle and a native checkpoint (sad_tpu's pickled param
tree, which sad_tpu loads too). The model is built on the CPU only for its
names, shapes and the values of parameters the blobs lack; nothing runs on
a device.

Usage:
  # reference blobs -> native checkpoint (the cfg shapes the model)
  python -m sad_tpu_torch.tools.convert_weights --cfg cfg.yaml \\
      --input R-50.pkl --output model.pkl

  # native checkpoint -> reference blobs
  python -m sad_tpu_torch.tools.convert_weights --cfg cfg.yaml --to-blobs \\
      --input model.pkl --output blobs.pkl
"""

from __future__ import annotations

import argparse
import pickle

import torch

from sad_tpu_torch.config import load_cfg
from sad_tpu_torch.convert import load_params
from sad_tpu_torch.models import create_model
from sad_tpu_torch.train.checkpoint import (
    fc_flatten_resolutions,
    load_checkpoint,
    reference_blobs_to_state_dict,
    save_checkpoint,
    state_dict_to_reference_blobs,
)
from sad_tpu_torch.utils.logging import setup_logging


def main(argv=None):
    logger = setup_logging("convert_weights")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--to-blobs", action="store_true")
    args = p.parse_args(argv)

    cfg = load_cfg(args.cfg_file)
    # the flattening FCs (fc6, the USE_FC_OUTPUT mask head) take the CHW <-> HWC
    # column permutation keyed by the RoI resolution: without it a converted
    # weight has the right shape and scrambled columns
    fc_res = fc_flatten_resolutions(cfg)
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    if args.to_blobs:
        load_params(model, load_checkpoint(args.input)["params"])
        blobs = state_dict_to_reference_blobs(model.state_dict(), fc_resolutions=fc_res)
        with open(args.output, "wb") as f:
            pickle.dump({"blobs": blobs}, f, pickle.HIGHEST_PROTOCOL)
        logger.info("Wrote %d blobs -> %s", len(blobs), args.output)
        return args.output
    with open(args.input, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("blobs", data) if isinstance(data, dict) else data
    sd, loaded, skipped = reference_blobs_to_state_dict(blobs, model, fc_resolutions=fc_res)
    model.load_state_dict(sd)
    save_checkpoint(args.output, model)
    logger.info("Converted %s -> %s (loaded %d blobs, skipped %d params)", args.input,
                args.output, len(loaded), len(skipped))
    for s in skipped[:20]:
        logger.info("  skipped: %s", s)
    return args.output


if __name__ == "__main__":
    main()
