"""Train a RetinaNet, a SAD student or an R-CNN (ref: sad_tpu/tools/train_net.py;
detectron/tools/train_net.py).

    python -m sad_tpu_torch.tools.train_net --cfg student.yaml \
        [--teacher_cfg teacher.yaml] [--skip-test] [--max-iters N] \
        [--device cuda|cpu] [--multi-gpu-testing] [KEY VALUE ...]
    torchrun --nproc_per_node W -m sad_tpu_torch.tools.train_net --cfg ... \
        [--multi-gpu-testing] [KEY VALUE ...]

Reference YAML configs load directly (the config surface is compatible).
Checkpoints, stats.jsonl and cfg.yaml go to OUTPUT_DIR/train/<datasets>/;
re-running on the same directory resumes (TRAIN.AUTO_RESUME). Unless
--skip-test, the trained student is then evaluated on TEST.DATASETS[0] on the
same device (test_net's evaluation: bbox_results.json and results.json in
OUTPUT_DIR/test/<datasets>/) and held to cfg.EXPECTED_RESULTS.

Under torchrun the W ranks train together (one card each, W dividing the
batch's images; over ``--nnodes N`` nodes, or with loss groups over several
ranks, on sad_tpu's multislice mesh; rank 0 writes every file), and the
evaluation runs sharded over them with or without --multi-gpu-testing: no
rank waits in a collective while another serves the whole test set.

    torchrun --nnodes 2 --nproc_per_node 8 --node_rank R --master_addr HOST \
        -m sad_tpu_torch.tools.train_net --cfg ... NUM_GPUS 8
"""

from __future__ import annotations

import argparse
import sys

from ..config import load_cfg
from ..config.config import get_output_dir
from ..parallel.distributed import world_size
from ..train.train_loop import train_model
from ..utils.logging import setup_logging
from .test_net import evaluate_and_check


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--teacher_cfg", dest="teacher_cfg_file", default=None)
    p.add_argument("--skip-test", action="store_true")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--multi-gpu-testing", action="store_true",
                   help="evaluate sharded over the torchrun world (always so under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default), 'cuda:N' or 'cpu'; no fallback from the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None):
    logger = setup_logging("train_net")
    args = parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.opts or None)
    teacher_cfg = load_cfg(args.teacher_cfg_file) if args.teacher_cfg_file else None
    if cfg.MODEL.TYPE == "distillation" and teacher_cfg is None:
        logger.error("MODEL.TYPE=distillation requires --teacher_cfg")
        sys.exit(1)

    result = train_model(cfg, teacher_cfg, max_iters=args.max_iters, device=args.device)
    logger.info("Training complete -> %s", get_output_dir(cfg, training=True))
    if not args.skip_test:
        results = evaluate_and_check(cfg, result.model,
                                     multi_gpu=args.multi_gpu_testing or world_size() > 1)
        logger.info("Eval results: %s", results)
    return result


if __name__ == "__main__":
    main()
