"""Cityscapes instance-segmentation result export and evaluation hook
(ref: sad_tpu/eval/cityscapes_eval.py; cityscapes_json_dataset_evaluator.py:
37-96 of the reference).

For each image it writes a ``<basename>pred.txt`` manifest, one line a
detection (``<png path> <cityscapes label id> <score>``), and a binary
instance-mask PNG a detection: the input of the official
``cityscapesscripts`` instance-level evaluation. That evaluator runs if it
is installed; otherwise the export directory is left for the official tool
to run elsewhere, and ``evaluate_masks`` returns None with a warning, as
sad_tpu's does.

PIL writes the PNGs; masks come from the port's RLE codec
(sad_tpu_torch/utils/segms.py).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# Cityscapes instance-class name -> label id (cityscapesscripts labels.py,
# the 8 instance-evaluated classes).
CITYSCAPES_NAME_TO_LABEL_ID = {
    "person": 24,
    "rider": 25,
    "car": 26,
    "truck": 27,
    "bus": 28,
    "train": 31,
    "motorcycle": 32,
    "bicycle": 33,
}


def export_cityscapes_results(
    roidb: Sequence[Dict],
    detections: Sequence[Dict],
    contiguous_to_name: Dict[int, str],
    output_dir: str,
    name_to_label_id: Optional[Dict[str, int]] = None,
) -> str:
    """Write pred.txt manifests + instance-mask PNGs for every roidb image.

    detections: COCO-style dicts from run_inference_on_roidb with
    'segmentation' RLE; 'category_id' values must be keys of
    contiguous_to_name. Returns output_dir.
    """
    from PIL import Image

    from ..utils.segms import rle_to_mask

    labels = name_to_label_id or CITYSCAPES_NAME_TO_LABEL_ID
    results_dir = os.path.join(output_dir, "results")
    os.makedirs(results_dir, exist_ok=True)

    by_image: Dict = {}
    for d in detections:
        by_image.setdefault(d["image_id"], []).append(d)

    for i, entry in enumerate(roidb):
        basename = os.path.splitext(os.path.basename(entry["image"]))[0]
        txtname = os.path.join(output_dir, basename + "pred.txt")
        if i % 10 == 0:
            logger.info("export %d: %s", i, basename)
        with open(txtname, "w") as fid:
            for k, det in enumerate(by_image.get(entry["id"], [])):
                name = contiguous_to_name.get(int(det["category_id"]))
                if name is None or name not in labels:
                    continue
                if "segmentation" not in det:
                    continue
                mask = rle_to_mask(det["segmentation"])
                pngname = os.path.join(
                    "results", f"{basename}_{name}_{k}.png"
                )
                Image.fromarray(
                    (mask.astype(np.uint8)) * 255
                ).save(os.path.join(output_dir, pngname))
                fid.write(
                    f"{pngname} {labels[name]} {float(det['score'])}\n"
                )
    return output_dir


def evaluate_masks(
    roidb: Sequence[Dict],
    detections: Sequence[Dict],
    contiguous_to_name: Dict[int, str],
    output_dir: str,
    raw_dataset_dir: Optional[str] = None,
) -> Optional[Dict]:
    """Export + run the official cityscapesscripts evaluator if available
    (ref: cityscapes_json_dataset_evaluator.py:60-96). Returns None when the
    external package is absent; the exported files remain for offline use.
    """
    export_cityscapes_results(
        roidb, detections, contiguous_to_name, output_dir
    )
    if raw_dataset_dir:
        os.environ["CITYSCAPES_DATASET"] = raw_dataset_dir
    os.environ["CITYSCAPES_RESULTS"] = output_dir
    try:
        import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling as cs  # noqa: E501
    except ImportError:
        logger.warning(
            "cityscapesscripts not installed; results exported to %s for "
            "offline evaluation", output_dir,
        )
        return None
    logger.info("Evaluating with cityscapesscripts...")
    cs.main([])
    return None
