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
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..config import load_cfg
from ..config.config import get_output_dir
from ..eval import test_engine
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


def main(argv=None):
    logger = setup_logging("test_net")
    args = parse_args(argv)
    opts = list(args.opts or [])
    if args.vis:
        opts += ["VIS", "True"]
    cfg = load_cfg(args.cfg_file, opts or None)
    if cfg.MODEL.TYPE == "rpn":
        raise NotImplementedError(
            "MODEL.TYPE='rpn' (RPN-only proposals and their recall, eval/rpn_generator.py) is "
            "not ported to sad_tpu_torch yet (ROADMAP.md Queue 1 item 8)")
    dist_info = init_distributed(device=args.device)
    if args.multi_gpu_testing and dist_info.world == 1:
        logger.info("--multi-gpu-testing without torchrun: one process serves")
    if dist_info.world > 1 and not args.multi_gpu_testing and not dist_info.is_main:
        logger.info("rank %d: rank 0 serves (no --multi-gpu-testing)", dist_info.rank)
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
