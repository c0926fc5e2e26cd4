"""Convert MATLAB selective-search proposals to the proposal-file format (a
copy of sad_tpu/tools/convert_selective_search.py; ref
detectron/tools/convert_selective_search.py).

The .mat holds ``boxes`` (a cell array, one an image) in MATLAB's 1-based
[y1 x1 y2 x2] order and ``images`` (the ids); the output is the pickle
{'boxes', 'scores', 'ids'} that TRAIN / TEST.PROPOSAL_FILES take
(eval/rpn_generator.add_proposals_to_roidb, Fast R-CNN).

Usage:
  python -m sad_tpu_torch.tools.convert_selective_search \
      --mat selective_search.mat --output proposals.pkl [--id-map ann.json]
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("convert_selective_search")


def convert_boxes(mat_boxes: np.ndarray) -> np.ndarray:
    """[y1 x1 y2 x2] 1-based -> [x1 y1 x2 y2] 0-based."""
    b = np.asarray(mat_boxes, np.float32)
    if b.size == 0:
        return np.zeros((0, 4), np.float32)
    out = b[:, [1, 0, 3, 2]] - 1.0
    return out


def main(argv=None):
    import scipy.io

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mat", required=True)
    p.add_argument("--output", required=True)
    p.add_argument(
        "--id-map", default=None,
        help="COCO-style annotation json mapping file_name -> image id",
    )
    args = p.parse_args(argv)

    mat = scipy.io.loadmat(args.mat)
    raw_boxes = mat["boxes"].ravel()
    names = [str(np.squeeze(x)) for x in mat["images"].ravel()]

    name_to_id = None
    if args.id_map:
        with open(args.id_map) as f:
            ann = json.load(f)
        name_to_id = {
            im["file_name"].rsplit(".", 1)[0]: im["id"] for im in ann["images"]
        }

    boxes, scores, ids = [], [], []
    for name, bx in zip(names, raw_boxes):
        b = convert_boxes(bx)
        boxes.append(b)
        scores.append(np.zeros((len(b),), np.float32))
        ids.append(name_to_id[name] if name_to_id else name)

    with open(args.output, "wb") as f:
        pickle.dump({"boxes": boxes, "scores": scores, "ids": ids}, f,
                    pickle.HIGHEST_PROTOCOL)
    logger.info("Converted %d images' proposals -> %s", len(ids), args.output)


if __name__ == "__main__":
    main()
