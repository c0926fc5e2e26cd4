"""ImageNet-VID-protocol evaluation (ref: sad_tpu/eval/vid_eval.py;
vid_dataset_evaluator.py and vid_eval.py of the reference).

The protocol is the COCO matching and accumulation with VID's parameters:
the same IoU and recall grids and maxDets, with every area range capped at
1e5^2 in place of COCO's 1e10 (vid_eval.py:507-516 setDetParams). It runs
the port's COCOEvaluator (eval/coco_eval.py) with those parameters.
"""

from __future__ import annotations

from typing import Dict, Sequence

from .coco_eval import COCOEvaluator

# vid_eval.py:507-516: areaRng [[0, 1e5^2], [0, 32^2], [32^2, 96^2],
# [96^2, 1e5^2]]
VID_AREA_RNGS = {
    "all": (0.0, 1e5 ** 2),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e5 ** 2),
}
VID_MAX_DETS = (1, 10, 100)


def vid_evaluator(gt_dataset: Dict, iou_type: str = "bbox") -> COCOEvaluator:
    """A COCOEvaluator configured with the VID protocol parameters."""
    return COCOEvaluator(
        gt_dataset, iou_type,
        area_rngs=VID_AREA_RNGS, max_dets=VID_MAX_DETS,
    )


def evaluate_vid_detections(
    gt_dataset: Dict, detections: Sequence[Dict], iou_type: str = "bbox",
) -> Dict[str, float]:
    """Evaluate COCO-format detections under the VID protocol (ref:
    vid_dataset_evaluator.py evaluate_boxes/_do_detection_eval)."""
    return vid_evaluator(gt_dataset, iou_type).evaluate(detections)
