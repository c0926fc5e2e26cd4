"""Evaluate saved detection results again (a copy of sad_tpu/tools/reval.py;
ref detectron/tools/reval.py): the COCO evaluator, or with --voc the VOC
protocol.

Usage:
  python -m sad_tpu_torch.tools.reval --dataset coco_2017_val \
      --results out/test/.../bbox_results.json [--voc] [--voc-07]
"""

from __future__ import annotations

import argparse
import json

from sad_tpu_torch.data.dataset import CocoDataset
from sad_tpu_torch.eval.coco_eval import COCOEvaluator
from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("reval")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--results", required=True)
    p.add_argument("--voc", action="store_true", help="VOC protocol instead")
    p.add_argument("--voc-07", action="store_true", help="VOC07 11-point AP")
    args = p.parse_args(argv)

    ds = CocoDataset(args.dataset)
    with open(args.results) as f:
        dets = json.load(f)
    if args.voc:
        from sad_tpu_torch.eval.voc_eval import voc_eval_boxes

        res = voc_eval_boxes(ds.dataset, dets, use_07_metric=args.voc_07)
    else:
        res = COCOEvaluator(ds.dataset).evaluate(dets, verbose=True)
    logger.info("Results: %s", res)
    return res


if __name__ == "__main__":
    main()
