"""Evaluate a model on TEST.DATASETS (ref: sad_tpu/tools/test_net.py;
detectron/tools/test_net.py).

Also the pseudo-label generator: with --pseudo-out, teacher detections over
TEST.DATASETS[0] become a COCO-format annotation json (SURVEY.md §3.4).

    python -m sad_tpu_torch.tools.test_net --cfg cfg.yaml --weights model.pkl \
        [--batch-size 8] [--range START END] [--vis] [--device cuda|cpu] [KEY VALUE ...]
    python -m sad_tpu_torch.tools.test_net --cfg teacher.yaml --weights t.pkl \
        --pseudo-out pseudo.json
    torchrun --nproc_per_node W -m sad_tpu_torch.tools.test_net --multi-gpu-testing ...

--weights is a native checkpoint of either package or a reference Caffe2
blob pickle; without it (and without TEST.WEIGHTS) the model keeps its seeded
random initialisation. The model runs on the card unless --device cpu asks
for the CPU; there is no fallback. bbox_results.json, results.json and
timing.json go to OUTPUT_DIR/test/<datasets>/; cfg.EXPECTED_RESULTS is then
checked (the reference's quality gate).

--multi-gpu-testing under torchrun shards the dataset (after --range) over
the W ranks, one card each; rank 0 merges the detections in the
one-process order, evaluates and writes the files (or the pseudo-label
json). Without the flag rank 0 alone serves; without torchrun one process
serves.

MODEL.TYPE 'rpn' (RPN-only; ref: sad_tpu/tools/test_net.py:94-112) writes
the proposals over TEST.DATASETS[0] to OUTPUT_DIR/test/<datasets>/
rpn_proposals.pkl, scores their recall against the dataset's ground truth
(eval/rpn_generator.evaluate_box_proposals), logs AR and returns the recall
dict; rank 0 alone serves under torchrun. The file is the TRAIN /
TEST.PROPOSAL_FILES of a Fast R-CNN config (MODEL.FASTER_RCNN False):

    python -m sad_tpu_torch.tools.test_net --cfg sad_tpu_torch/configs/rpn_R-50-FPN.yaml
    python -m sad_tpu_torch.tools.train_net --cfg sad_tpu_torch/configs/fast_rcnn_R-50-FPN.yaml \
        TRAIN.PROPOSAL_FILES "('<rpn train-set output>/rpn_proposals.pkl',)"
    python -m sad_tpu_torch.tools.test_net --cfg sad_tpu_torch/configs/fast_rcnn_R-50-FPN.yaml \
        --weights <model_final.pkl> TEST.PROPOSAL_FILES "('<rpn output>/rpn_proposals.pkl',)"
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from ..config import load_cfg
from ..config.config import get_output_dir
from ..data.dataset import CocoDataset
from ..eval import rpn_generator, test_engine
from ..eval.task_evaluation import check_expected_results
from ..models.model_builder import compute_dtype, create_model
from ..parallel.distributed import init_distributed, rank_device
from ..train.checkpoint import load_reference_or_native
from ..utils.logging import setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pseudo-out", default=None)
    p.add_argument("--pseudo-score-thresh", type=float, default=0.5)
    p.add_argument("--wait", action="store_true",
                   help="wait for the weights file to exist (ref test_net.py --wait)")
    p.add_argument("--vis", action="store_true", help="visualize detections (sets VIS True)")
    p.add_argument("--range", dest="im_range", type=int, nargs=2, default=None,
                   metavar=("START", "END"),
                   help="evaluate images [START, END) of the dataset (ref test_net.py --range)")
    p.add_argument("--multi-gpu-testing", action="store_true",
                   help="shard the dataset over the torchrun world (one card a rank)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default), 'cuda:N' or 'cpu'; no fallback from the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def evaluate_and_check(cfg, model, batch_size: int = 8, im_range=None,
                       multi_gpu: bool = False):
    """test_net_on_dataset on cfg.TEST.DATASETS[0] into OUTPUT_DIR/test/...,
    then the EXPECTED_RESULTS gate (ref: lib/core/config.py:966-973 +
    task_evaluation.check_expected_results): a miss raises
    ExpectedResultsError. Shared by test_net and train_net. ``multi_gpu``:
    sharded over the torchrun world, every rank checking the merged
    results."""
    results = test_engine.test_net_on_dataset(
        cfg, model, batch_size=batch_size, output_dir=get_output_dir(cfg, training=False),
        im_range=im_range, multi_gpu=multi_gpu)
    if cfg.EXPECTED_RESULTS:
        check_expected_results(cfg, {cfg.TEST.DATASETS[0]: {"box": results}})
    return results


def rpn_proposals_and_recall(cfg, model, batch_size: int = 8):
    """RPN-only: the proposals over TEST.DATASETS[0] into
    OUTPUT_DIR/test/<datasets>/rpn_proposals.pkl and their recall against
    its ground truth (rpn_generator.evaluate_box_proposals's dict, with
    'proposal_file')."""
    logger = logging.getLogger("test_net")
    out_file = os.path.join(get_output_dir(cfg, training=False), "rpn_proposals.pkl")
    props = rpn_generator.generate_rpn_on_dataset(cfg, model, batch_size=batch_size,
                                                  output_file=out_file)
    gt_roidb = CocoDataset(cfg.TEST.DATASETS[0]).get_roidb(include_gt=True)
    rec = rpn_generator.evaluate_box_proposals(props, gt_roidb)
    logger.info("Proposal AR=%.4f over %d gt boxes -> %s", rec["ar"], rec["num_pos"], out_file)
    return dict(rec, proposal_file=out_file)


def main(argv=None):
    logger = setup_logging("test_net")
    args = parse_args(argv)
    opts = list(args.opts or [])
    if args.vis:
        opts += ["VIS", "True"]
    cfg = load_cfg(args.cfg_file, opts or None)
    rpn_only = cfg.MODEL.TYPE == "rpn"
    dist_info = init_distributed(device=args.device)
    if args.multi_gpu_testing and dist_info.world == 1:
        logger.info("--multi-gpu-testing without torchrun: one process serves")
    if dist_info.world > 1 and (rpn_only or not args.multi_gpu_testing) and (
            not dist_info.is_main):
        logger.info("rank %d: rank 0 serves (%s)", dist_info.rank,
                    "RPN-only" if rpn_only else "no --multi-gpu-testing")
        return None
    dev = rank_device(args.device)
    model = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    weights = args.weights or cfg.TEST.WEIGHTS
    if args.wait and weights:
        while not os.path.exists(weights):
            logger.info("Waiting for %s to exist...", weights)
            time.sleep(10)
    if weights:
        load_reference_or_native(weights, model, cfg)
        logger.info("Loaded weights: %s", weights)
    model.to(compute_dtype(cfg))

    if rpn_only:
        return rpn_proposals_and_recall(cfg, model, args.batch_size)
    if args.pseudo_out:
        test_engine.generate_pseudo_labels(
            cfg, model, cfg.TEST.DATASETS[0], args.pseudo_out,
            score_thresh=args.pseudo_score_thresh, batch_size=args.batch_size,
            multi_gpu=args.multi_gpu_testing)
        return None
    results = evaluate_and_check(cfg, model, args.batch_size,
                                 tuple(args.im_range) if args.im_range else None,
                                 multi_gpu=args.multi_gpu_testing)
    logger.info("Results: %s", results)
    return results


if __name__ == "__main__":
    main()
