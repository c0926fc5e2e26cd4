"""Typed, immutable configuration system.

A copy of sad_tpu/config/config.py, whole: the same schema, YAML surface,
type aliases and key checks (tests/test_torch_config.py holds the two
equal).

Replaces the reference's global mutable ``cfg`` AttrDict and its
teacher/student global-swap machinery (``detectron/lib/core/config.py:59-65,
1254-1272``) with frozen dataclasses: the teacher and the student are simply
two independent ``Config`` values passed around explicitly.

The YAML surface is kept compatible with the reference's config files
(``detectron/configs/focal_distillation/*.yaml``): the same section/key names
parse into the dataclass fields, unknown keys raise (mirroring
``config.py:1146-1151``), and the deprecated/renamed-key machinery
(``config.py:1022-1061``) is preserved for the keys the reference deprecates.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import yaml


# --------------------------------------------------------------------------- #
# Section dataclasses. Defaults mirror detectron/lib/core/config.py defaults.
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class TrainConfig:
    """Training options (ref: config.py TRAIN section)."""

    WEIGHTS: str = ""
    DATASETS: Tuple[str, ...] = ()
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    IMS_PER_BATCH: int = 2  # images per device-group (ref: config.py:96)
    BATCH_SIZE_PER_IM: int = 64
    USE_FLIPPED: bool = True
    SNAPSHOT_ITERS: int = 20000
    AUTO_RESUME: bool = True
    # Checkpoint backend (framework-only key). 'pickle' = reference-format
    # flat pickles (net.py:149-182 analogue, the default); 'orbax' = async
    # saves that overlap training, the newest 5 kept, {params, velocity}
    # per step under OUTPUT_DIR/checkpoints (sad_tpu: an orbax.checkpoint
    # manager; the port: train/async_checkpoint.py). AUTO_RESUME works with
    # both.
    CHECKPOINT_BACKEND: str = "pickle"
    ASPECT_GROUPING: bool = True
    RPN_STRADDLE_THRESH: float = 0.0
    GT_MIN_AREA: int = -1
    CROWD_FILTER_THRESH: float = 0.7
    FREEZE_AT: int = 2  # ResNet freeze stage (ref: ResNet.py:88 freeze_at)
    # freeze the whole conv body (ref: config.py:189 TRAIN.FREEZE_CONV_BODY,
    # model_builder.py:200-207 StopGradient on blob_conv)
    FREEZE_CONV_BODY: bool = False
    # Fraction coming from proposals vs gt for R-CNN style training (unused by
    # RetinaNet; retained for the inherited surface).
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.0
    FG_FRACTION: float = 0.25
    # Online hard example mining for the box head (ref: config.py:195-197,
    # R-FCN-style BoxAnnotatorOHEM selection)
    OHEM: bool = False
    OHEM_ROI_PER_IMG: int = 128
    RPN_BATCH_SIZE_PER_IM: int = 256
    RPN_FG_FRACTION: float = 0.5
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_NMS_THRESH: float = 0.7
    RPN_MIN_SIZE: int = 0
    PROPOSAL_FILES: Tuple[str, ...] = ()



@dataclass(frozen=True)
class SoftNMSConfig:
    """Soft-NMS options (ref: config.py:411-417)."""

    ENABLED: bool = False
    METHOD: str = "linear"
    SIGMA: float = 0.5


@dataclass(frozen=True)
class BBoxVoteConfig:
    """Box-voting options (ref: config.py:423-438)."""

    ENABLED: bool = False
    VOTE_TH: float = 0.8
    SCORING_METHOD: str = "ID"
    SCORING_METHOD_BETA: float = 1.0


@dataclass(frozen=True)
class BBoxAugConfig:
    """Test-time bbox augmentation (ref: config.py:301-335)."""

    ENABLED: bool = False
    SCORE_HEUR: str = "UNION"
    COORD_HEUR: str = "UNION"
    H_FLIP: bool = False
    SCALES: Tuple[int, ...] = ()
    MAX_SIZE: int = 4000
    SCALE_H_FLIP: bool = False
    SCALE_SIZE_DEP: bool = False
    AREA_TH_LO: float = 50.0 ** 2
    AREA_TH_HI: float = 180.0 ** 2
    ASPECT_RATIOS: Tuple[float, ...] = ()
    ASPECT_RATIO_H_FLIP: bool = False


@dataclass(frozen=True)
class MaskAugConfig:
    """Test-time mask augmentation (ref: config.py:341-371)."""

    ENABLED: bool = False
    HEUR: str = "SOFT_AVG"
    H_FLIP: bool = False
    SCALES: Tuple[int, ...] = ()
    MAX_SIZE: int = 4000
    SCALE_H_FLIP: bool = False
    SCALE_SIZE_DEP: bool = False
    AREA_TH: float = 180.0 ** 2
    ASPECT_RATIOS: Tuple[float, ...] = ()
    ASPECT_RATIO_H_FLIP: bool = False


@dataclass(frozen=True)
class KpsAugConfig:
    """Test-time keypoint augmentation (ref: config.py:377-406)."""

    ENABLED: bool = False
    HEUR: str = "HM_AVG"
    H_FLIP: bool = False
    SCALES: Tuple[int, ...] = ()
    MAX_SIZE: int = 4000
    SCALE_H_FLIP: bool = False
    SCALE_SIZE_DEP: bool = False
    AREA_TH: float = 180.0 ** 2
    ASPECT_RATIOS: Tuple[float, ...] = ()
    ASPECT_RATIO_H_FLIP: bool = False


@dataclass(frozen=True)
class TestConfig:
    """Inference options (ref: config.py TEST section)."""

    WEIGHTS: str = ""
    DATASETS: Tuple[str, ...] = ()
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    BBOX_REG: bool = True
    SCORE_THRESH: float = 0.05
    DETECTIONS_PER_IM: int = 100
    SOFT_NMS: "SoftNMSConfig" = field(default_factory=lambda: SoftNMSConfig())
    BBOX_VOTE: "BBoxVoteConfig" = field(default_factory=lambda: BBoxVoteConfig())
    BBOX_AUG: "BBoxAugConfig" = field(default_factory=lambda: BBoxAugConfig())
    MASK_AUG: "MaskAugConfig" = field(default_factory=lambda: MaskAugConfig())
    KPS_AUG: "KpsAugConfig" = field(default_factory=lambda: KpsAugConfig())
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_NMS_THRESH: float = 0.7
    RPN_MIN_SIZE: int = 0
    # Dump raw per-image head outputs (cls probs + box preds) for the
    # pseudo-label/teacher pipeline. Replaces the reference's hard-coded
    # TEST.SAVE_RES dump path (test_retinanet.py:97-101) with a config option.
    SAVE_RES: bool = False
    SAVE_RES_DIR: str = ""
    # Reference-exact per-level top-N candidate selection
    # (test_retinanet.py:136-139 argpartitions the full score vector). When
    # False, TPU decode may use jax.lax.approx_max_k (PartialReduce,
    # recall_target 0.99) — ~10x faster over the multi-million-score P3 grid;
    # measured mAP delta vs exact on a dense 512-image synthetic set: see
    # BENCH_NOTES.md (topk_parity_drive). Eval defaults to exact; throughput
    # benches opt into approx.
    EXACT_TOPK: bool = True
    # Pre-NMS candidate cap for the FINAL class-wise NMS of the R-CNN box
    # decode (eval/rcnn_inference.py). The reference NMS-es every
    # (roi, fg class) candidate above SCORE_THRESH (test.py:161-180, class
    # loop over the thresholded arrays); the dense TPU decode carries all
    # R x (C-1) slots (79k at R=1000, C=81), which overflows the
    # sublane-batched Pallas NMS kernel's VMEM ceiling and falls back to
    # the 1-of-8-sublanes single-problem kernel. N > 0 first takes the
    # exact top-N candidates by score (ops/topk PartialReduce) and NMS-es
    # those — bit-identical to the full set whenever <= N candidates clear
    # SCORE_THRESH (NEG_INF-masked slots can never be picked), and
    # identical in practice far beyond that (greedy NMS keeps
    # DETECTIONS_PER_IM=100 of the highest scorers). 0 = reference-exact
    # full candidate set.
    NMS_CAND_TOPK: int = 0
    PROPOSAL_FILES: Tuple[str, ...] = ()
    PROPOSAL_LIMIT: int = 2000
    COMPETITION_MODE: bool = True
    FORCE_JSON_DATASET_EVAL: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Model type/backbone selection (ref: config.py MODEL section)."""

    TYPE: str = ""  # 'retinanet' | 'distillation' | 'generalized_rcnn' | 'rfcn'
    CONV_BODY: str = ""  # e.g. 'FPN.add_fpn_ResNet50_conv5_body'
    NUM_CLASSES: int = -1  # includes background (81 for COCO)
    CLS_AGNOSTIC_BBOX_REG: bool = False
    FASTER_RCNN: bool = False
    MASK_ON: bool = False
    KEYPOINTS_ON: bool = False
    RPN_ONLY: bool = False
    EXECUTION_TYPE: str = "dag"  # kept for config parity; XLA schedules for us
    BBOX_REG_WEIGHTS: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    # extra scale on the box-regression loss (ref: config.py:497 +
    # detector.py GetBBoxLossScale)
    BBOX_REG_WEIGHT_SCALE: float = 1.0


@dataclass(frozen=True)
class FPNConfig:
    """Feature Pyramid Network options (ref: config.py FPN section)."""

    FPN_ON: bool = False
    DIM: int = 256
    ZERO_INIT_LATERAL: bool = False
    COARSEST_STRIDE: int = 32
    MULTILEVEL_ROIS: bool = False
    ROI_CANONICAL_SCALE: int = 224
    ROI_CANONICAL_LEVEL: int = 4
    ROI_MAX_LEVEL: int = 5
    ROI_MIN_LEVEL: int = 2
    MULTILEVEL_RPN: bool = False
    RPN_MAX_LEVEL: int = 6
    RPN_MIN_LEVEL: int = 2
    RPN_ASPECT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    RPN_ANCHOR_START_SIZE: int = 32
    EXTRA_CONV_LEVELS: bool = False


@dataclass(frozen=True)
class RetinaNetConfig:
    """RetinaNet head/loss options (ref: config.py RETINANET section)."""

    RETINANET_ON: bool = False
    ASPECT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    SCALES_PER_OCTAVE: int = 3
    ANCHOR_SCALE: float = 4.0
    NUM_CONVS: int = 4
    BBOX_REG_WEIGHT: float = 1.0
    BBOX_REG_BETA: float = 0.11
    PRE_NMS_TOP_N: int = 1000
    POSITIVE_OVERLAP: float = 0.5
    NEGATIVE_OVERLAP: float = 0.4
    LOSS_ALPHA: float = 0.25
    LOSS_GAMMA: float = 2.0
    PRIOR_PROB: float = 0.01
    SHARE_CLS_BBOX_TOWER: bool = False
    CLASS_SPECIFIC_BBOX: bool = False
    SOFTMAX: bool = False
    INFERENCE_TH: float = 0.05
    FINAL_KERNEL_SIZE: int = 3
    L2_LOSS: bool = False  # dead flag in the reference; kept for config parity


@dataclass(frozen=True)
class ResNetsConfig:
    """ResNet/ResNeXt body options (ref: config.py RESNETS section)."""

    NUM_GROUPS: int = 1  # >1 => ResNeXt
    WIDTH_PER_GROUP: int = 64
    STRIDE_1X1: bool = True
    TRANS_FUNC: str = "bottleneck_transformation"
    RES5_DILATION: int = 1
    CHANNEL_RATIO: float = 1.0  # half-width student ablation (ResNet.py:99-118)


@dataclass(frozen=True)
class RPNConfig:
    """Region Proposal Network options (ref: config.py RPN section)."""

    RPN_ON: bool = False
    SIZES: Tuple[int, ...] = (64, 128, 256, 512)
    STRIDE: int = 16
    ASPECT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # Proposal analogue of TEST.EXACT_TOPK (framework-only key): exact
    # pre-NMS candidate top-N per (level, image). When False, TPU uses
    # jax.lax.approx_max_k at recall_target 0.99 over the dense RPN score
    # grids (P2 alone is ~200k scores at 800x1344); non-TPU backends fall
    # back to exact. Applies to BOTH train and test proposal paths. Chip
    # measurements (BENCH_NOTES.md, rpn_topk_parity_drive): EVAL-time
    # −2.3e-4 AP on an exact-trained checkpoint; TRAIN-time (--train-both,
    # round 4) an approx-trained model matched the exact-trained one
    # bit-identically at 256-img/800-iter scale — though at that scale the
    # approx selection coincided with exact throughout, so the train-time
    # evidence bounds mild truncation pressure only. Default True.
    EXACT_TOPK: bool = True


@dataclass(frozen=True)
class FastRCNNConfig:
    """Fast/Faster R-CNN box head options (ref: config.py FAST_RCNN)."""

    ROI_BOX_HEAD: str = "fast_rcnn_heads.add_roi_2mlp_head"
    MLP_HEAD_DIM: int = 1024
    CONV_HEAD_DIM: int = 256
    NUM_STACKED_CONVS: int = 4
    ROI_XFORM_METHOD: str = "RoIAlign"
    # 14 matches the reference default (config.py:669) — the C4 family
    # relies on it; every FPN YAML overrides to 7 explicitly
    ROI_XFORM_RESOLUTION: int = 14
    ROI_XFORM_SAMPLING_RATIO: int = 2  # 0 (adaptive) is not traceable on TPU
    CONV_INIT: str = "GaussianFill"


@dataclass(frozen=True)
class MRCNNConfig:
    """Mask R-CNN head options (ref: config.py MRCNN)."""

    ROI_MASK_HEAD: str = "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs"
    # reference defaults (config.py:753,759): 14/7; the FPN mask YAMLs
    # override to 28/14 explicitly
    RESOLUTION: int = 14
    ROI_XFORM_METHOD: str = "RoIAlign"
    ROI_XFORM_RESOLUTION: int = 7
    ROI_XFORM_SAMPLING_RATIO: int = 2
    DIM_REDUCED: int = 256
    DILATION: int = 1
    CLS_SPECIFIC_MASK: bool = True
    WEIGHT_LOSS_MASK: float = 1.0
    THRESH_BINARIZE: float = 0.5
    CONV_INIT: str = "GaussianFill"
    UPSAMPLE_RATIO: int = 1
    USE_FC_OUTPUT: bool = False
    # TPU extension (no reference analogue): static per-image RoI slot count
    # for the mask branch. -1 = the box head's fg cap
    # (BATCH_SIZE_PER_IM * FG_FRACTION = 128 at reference settings), which is
    # the reference's own worst case — its dynamic shapes pay only the
    # ACTUAL fg count per step. Lower caps trade worst-case supervision
    # coverage for a proportional cut of the (MXU-bound) aux-branch cost;
    # fg rois beyond the cap keep box supervision but get no mask loss.
    ROI_SLOTS_PER_IM: int = -1


@dataclass(frozen=True)
class KRCNNConfig:
    """Keypoint R-CNN head options (ref: config.py KRCNN)."""

    ROI_KEYPOINTS_HEAD: str = "keypoint_rcnn_heads.add_roi_pose_head_v1convX"
    NUM_KEYPOINTS: int = 17
    NUM_STACKED_CONVS: int = 8
    # reference defaults (config.py:802,829,845): the keypoint YAMLs all
    # override CONV_HEAD_DIM=512 / HEATMAP_SIZE=56 / RESOLUTION=14
    CONV_HEAD_DIM: int = 256
    CONV_HEAD_KERNEL: int = 3
    UP_SCALE: int = 2
    HEATMAP_SIZE: int = -1
    ROI_XFORM_METHOD: str = "RoIAlign"
    ROI_XFORM_RESOLUTION: int = 7
    ROI_XFORM_SAMPLING_RATIO: int = 2
    LOSS_WEIGHT: float = 1.0
    NORMALIZE_BY_VISIBLE_KEYPOINTS: bool = True
    CONV_INIT: str = "GaussianFill"
    USE_DECONV_OUTPUT: bool = False
    KEYPOINT_CONFIDENCE: str = "bbox"
    MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH: int = 20
    NMS_OKS: bool = False
    # TPU extension: static per-image RoI slot count for the keypoint branch
    # (see MRCNN.ROI_SLOTS_PER_IM; the 8x512-wide keypoint tower measures
    # 85% of bf16 MXU peak, so its cost is linear in this cap)
    ROI_SLOTS_PER_IM: int = -1
    # minimum upsampled-heatmap extent at decode (ref: config.py:854 +
    # keypoints.py:129-134)
    INFERENCE_MIN_SIZE: int = 0


@dataclass(frozen=True)
class SolverConfig:
    """SGD schedule options (ref: config.py SOLVER section)."""

    BASE_LR: float = 0.001
    LR_POLICY: str = "step"  # 'step' | 'steps_with_decay' | 'steps_with_lrs'
    GAMMA: float = 0.1
    STEP_SIZE: int = 30000
    STEPS: Tuple[int, ...] = ()
    LRS: Tuple[float, ...] = ()
    MAX_ITER: int = 40000
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    WARM_UP_ITERS: int = 500
    WARM_UP_FACTOR: float = 1.0 / 3.0
    WARM_UP_METHOD: str = "linear"
    SCALE_MOMENTUM: bool = True
    SCALE_MOMENTUM_THRESHOLD: float = 1.1
    LOG_LR_CHANGE_THRESHOLD: float = 1.1


@dataclass(frozen=True)
class DistillationConfig:
    """Adaptive distillation options (ref: config.py:989-1016)."""

    DISTILLATION_ON: bool = False
    LOSS_ALPHA: float = 0.0
    LOSS_GAMMA: float = 0.0
    LOSS_BETA: float = 0.0
    IGNORED_LABEL: int = -1
    TEMPERATURE: float = 1.0
    ADAPTIVE_NORMALIZER: bool = False
    LOGITS_POWER: float = 1.0
    UNLABEL_DISTILLATION: bool = False
    UNLABEL_DATASETS: Tuple[str, ...] = ()


@dataclass(frozen=True)
class DataLoaderConfig:
    """Host data pipeline (ref: config.py:205-210 DATA_LOADER).

    NUM_THREADS mirrors the reference's loader thread count. NUM_PROCESSES
    is a TPU-side addition: >0 selects the multi-process minibatch builder
    (data/mp_loader.py) — the threaded builder is GIL-bound and cannot feed
    a chip that consumes >100 imgs/s; -1 auto-sizes to host cores - 1."""

    NUM_THREADS: int = 4
    NUM_PROCESSES: int = 0
    # Ship ONE raw uint8 canvas per image and normalize per stream on
    # device (sad_tpu.ops.image_norm): 4x less host->device traffic (8x for
    # distillation, where the canvas serves both normalization streams) and
    # the host skips its normalize passes. Bit-identical results (canvas
    # padding is masked back to exact 0.0 on device).
    DEVICE_NORMALIZE: bool = True


@dataclass(frozen=True)
class Config:
    """Top-level immutable config (one per model; teacher and student are two
    separate instances — replacing the reference's register_teacher /
    switch_to_teacher global swaps, config.py:1254-1272)."""

    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    FPN: FPNConfig = field(default_factory=FPNConfig)
    RETINANET: RetinaNetConfig = field(default_factory=RetinaNetConfig)
    RESNETS: ResNetsConfig = field(default_factory=ResNetsConfig)
    RPN: RPNConfig = field(default_factory=RPNConfig)
    FAST_RCNN: FastRCNNConfig = field(default_factory=FastRCNNConfig)
    MRCNN: MRCNNConfig = field(default_factory=MRCNNConfig)
    KRCNN: KRCNNConfig = field(default_factory=KRCNNConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    DISTILLATION: DistillationConfig = field(default_factory=DistillationConfig)
    DATA_LOADER: DataLoaderConfig = field(default_factory=DataLoaderConfig)

    NUM_GPUS: int = 1  # number of device-groups; on TPU = mesh data-axis size
    DEDUP_BOXES: float = 1.0 / 16.0
    BBOX_XFORM_CLIP: float = float(np.log(1000.0 / 16.0))
    # Pixel normalization (BGR order, matching the reference's cv2 pipeline;
    # config.py:929-933).
    PIXEL_MEANS: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    PIXEL_DIV: float = 1.0
    PIXEL_STD: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    RNG_SEED: int = 3
    OUTPUT_DIR: str = "/tmp/sad_tpu_output"
    EXPECTED_RESULTS: Tuple = ()
    EXPECTED_RESULTS_RTOL: float = 0.1
    EXPECTED_RESULTS_ATOL: float = 0.005
    VIS: bool = False
    VIS_TH: float = 0.9
    USE_NCCL: bool = False  # parity knob; collectives are XLA's on TPU
    DOWNLOAD_CACHE: str = "/tmp/sad_tpu_download_cache"

    # TPU-specific additions (not in the reference):
    # compute dtype for backbone/head matmuls ('bfloat16' or 'float32');
    # losses always accumulate in float32.
    COMPUTE_DTYPE: str = "bfloat16"
    # Rematerialize backbone activations in backward (jax.checkpoint in
    # sad_tpu, torch.utils.checkpoint in the port) — the analogue of the
    # reference's memonger gradient-blob sharing (train_net.py:247-258,
    # python/memonger.py): trade FLOPs for device memory.
    REMAT_BACKBONE: bool = False
    # Space-to-depth conv1 (MLPerf-style): compute the 7x7/s2 stem as a
    # weight-equivalent 4x4/s1 conv over 2x2-blocked 12-channel input.
    # Same outputs, same checkpoint layout (param stays (7,7,3,64)); only
    # the on-device compute layout changes. See sad_tpu's models/resnet.py
    # Conv1S2D; the port runs the 7x7 stem (faster on the H100) and refuses
    # an odd canvas as sad_tpu does (models/resnet.py).
    S2D_STEM: bool = False
    # Fold each AffineChannel's frozen scale into the preceding conv's
    # weights at trace time (y = conv(x, W*s) + b) — the XLA-level analogue
    # of the reference converter's BN-fold trick
    # (tools/pickle_caffe_blobs.py:148-170), applied to the live forward
    # instead of the checkpoint. Param tree, checkpoints, and converter are
    # untouched (W and s stay separate parameters; the fold is a trace-time
    # rewrite). Exactly equivalent in f32; bf16 rounding differs in the
    # last bit. See models/resnet.py and tests/test_affine_fold.py.
    FOLD_AFFINE: bool = False
    # When set, the train loop captures a jax.profiler trace of a few steps
    # into this directory — the prof_dag/htrace analogue (SURVEY.md §5.1).
    PROFILE_DIR: str = ""
    PROFILE_START_ITER: int = 10
    PROFILE_NUM_ITERS: int = 5
    # Use the fused Pallas loss kernel instead of the jnp ops. The round-2
    # redesign (lane packing 8x80->640, in-kernel PowSum, per-group raw
    # sums) closed the gap from -13% to -2.8% on the joint SAD step
    # (measured honestly with evolving state: XLA 156.5 vs Pallas 161.0
    # ms/step at bs16; BENCH_NOTES.md) — XLA's multi-output fusion still
    # wins, so the default stays off; the kernel remains fully tested
    # against the CUDA-transcription oracles.
    USE_PALLAS_LOSSES: bool = False

    # ---------------------------------------------------------------- helpers

    def num_fpn_levels(self) -> int:
        return self.FPN.RPN_MAX_LEVEL - self.FPN.RPN_MIN_LEVEL + 1

    def fpn_levels(self) -> Tuple[int, ...]:
        return tuple(range(self.FPN.RPN_MIN_LEVEL, self.FPN.RPN_MAX_LEVEL + 1))

    def num_anchors_per_cell(self) -> int:
        return len(self.RETINANET.ASPECT_RATIOS) * self.RETINANET.SCALES_PER_OCTAVE

    def num_fg_classes(self) -> int:
        return self.MODEL.NUM_CLASSES - 1


# --------------------------------------------------------------------------- #
# Deprecated / renamed keys (ref: config.py:1022-1061)
# --------------------------------------------------------------------------- #

_DEPRECATED_KEYS = {
    "FINAL_MSG",
    "MODEL.DILATION",
    "ROOT_GPU_ID",
    "RPN.ON",
    "TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED",
    "TRAIN.DROPOUT",
    "USE_GPU_NMS",
    "TEST.NUM_TEST_IMAGES",
}

_RENAMED_KEYS = {
    "EXAMPLE.RENAMED.KEY": "EXAMPLE.KEY",
    "PIXEL_MEAN": "PIXEL_MEANS",
    "MODEL.PS_GRID_SIZE": "RFCN.PS_GRID_SIZE",
    "MODEL.ROI_HEAD": "FAST_RCNN.ROI_BOX_HEAD",
    "MODEL.RPN_HEAD": "RPN.RPN_HEAD",
    "TRAIN.DATASET": "TRAIN.DATASETS",
    "TRAIN.PROPOSAL_FILE": "TRAIN.PROPOSAL_FILES",
    "TEST.DATASET": "TEST.DATASETS",
    "TEST.PROPOSAL_FILE": "TEST.PROPOSAL_FILES",
}

# Sections present in reference YAMLs that sad_tpu does not model yet; keys in
# these sections are validated as "known but inert" so upstream configs load.
_INERT_SECTIONS = {"RFCN", "VGG", "VGG_CNN_M_1024"}

# Top-level scalar keys from the reference accepted but unused on TPU.
_INERT_TOP_KEYS = {
    "DEBUG",
    "MEMONGER",
    "MEMONGER_SHARE_ACTIVATIONS",
    "CLUSTER",
    "MATLAB",
    "REQUIRE_MASK",
}


class ConfigError(Exception):
    pass


def _coerce(value: Any, target_type: type, key: str) -> Any:
    """Coerce a YAML value to the dataclass field's type, mirroring the
    reference's type-coercion rules (config.py:1201-1252): strings that parse
    as literals are evaluated; lists become tuples; ints/floats interconvert."""
    if isinstance(value, str):
        try:
            parsed = ast.literal_eval(value)
            value = parsed
        except (ValueError, SyntaxError):
            pass
    if isinstance(value, list):
        value = tuple(value)
    origin = getattr(target_type, "__origin__", None)
    if origin is tuple:
        if not isinstance(value, tuple):
            value = (value,)
        return tuple(value)
    if target_type is float and isinstance(value, int):
        return float(value)
    if target_type is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if target_type is bool and isinstance(value, bool):
        return value
    if target_type is str and not isinstance(value, str):
        raise ConfigError(f"Type mismatch for key {key}: expected str, got {value!r}")
    return value


def _merge_section(section_obj: Any, updates: Dict[str, Any], prefix: str) -> Any:
    field_map = {f.name: f for f in fields(section_obj)}
    kwargs = {}
    for key, value in updates.items():
        full_key = f"{prefix}.{key}" if prefix else key
        if full_key in _DEPRECATED_KEYS or key in _DEPRECATED_KEYS:
            continue
        if full_key in _RENAMED_KEYS:
            raise ConfigError(
                f"Key {full_key} was renamed to {_RENAMED_KEYS[full_key]}"
            )
        if key not in field_map:
            raise ConfigError(f"Non-existent config key: {full_key}")
        f = field_map[key]
        current = getattr(section_obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _merge_section(current, value, full_key)
            continue
        kwargs[key] = _coerce(value, f.type if isinstance(f.type, type) else _resolve_type(section_obj, f), full_key)
    return replace(section_obj, **kwargs)


def _resolve_type(obj: Any, f: dataclasses.Field) -> type:
    # dataclass field types may be strings under `from __future__ import
    # annotations`; resolve the common cases we use.
    t = f.type
    if isinstance(t, str):
        simple = {"int": int, "float": float, "bool": bool, "str": str}
        if t in simple:
            return simple[t]
        if t.startswith("Tuple"):
            return tuple
    return t if isinstance(t, type) else object


def merge_cfg_from_dict(cfg: Config, d: Dict[str, Any]) -> Config:
    """Merge a (nested) dict of overrides into an immutable Config, returning
    a new Config. Unknown keys raise, matching config.py:1146-1151."""
    top_fields = {f.name: f for f in fields(cfg)}
    kwargs: Dict[str, Any] = {}
    for key, value in d.items():
        if key in _DEPRECATED_KEYS:
            continue
        if key in _RENAMED_KEYS:
            raise ConfigError(f"Key {key} was renamed to {_RENAMED_KEYS[key]}")
        if key in _INERT_SECTIONS or key in _INERT_TOP_KEYS:
            continue  # accepted for upstream-yaml compatibility, not modeled
        if key not in top_fields:
            raise ConfigError(f"Non-existent config key: {key}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _merge_section(current, value, key)
        else:
            kwargs[key] = _coerce(value, _resolve_type(cfg, top_fields[key]), key)
    return replace(cfg, **kwargs)


def cfg_to_dict(cfg) -> Dict[str, Any]:
    """Config -> plain nested dict (tuples as lists) — yaml/json friendly."""
    out: Dict[str, Any] = {}
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = cfg_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = [cfg_to_dict(x) if dataclasses.is_dataclass(x)
                           else x for x in v]
        else:
            out[f.name] = v
    return out


def cfg_to_yaml(cfg: Config) -> str:
    """Serialize a Config to YAML that merge_cfg_from_dict round-trips.
    Used to embed the active config in checkpoints (ref: net.py:149-182
    stores 'cfg': yaml in every weights pkl) and to drop a cfg.yaml into
    the output dir for the run dashboard."""
    return yaml.safe_dump(cfg_to_dict(cfg), sort_keys=True,
                          default_flow_style=None)


def merge_cfg_from_file(cfg: Config, yaml_path: str) -> Config:
    """Load a YAML file (reference-format) and merge it into cfg."""
    with open(yaml_path, "r") as f:
        d = yaml.safe_load(f)
    if d is None:
        return cfg
    return merge_cfg_from_dict(cfg, d)


def merge_cfg_from_list(cfg: Config, opts: List[str]) -> Config:
    """Merge 'KEY VALUE' pair overrides (CLI style, ref config.py:1111)."""
    assert len(opts) % 2 == 0, "opts must be key/value pairs"
    d: Dict[str, Any] = {}
    for key, value in zip(opts[0::2], opts[1::2]):
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return merge_cfg_from_dict(cfg, d)


# Deprecated MODEL.TYPE spellings the reference still resolves via get_func
# (model_builder.py:511-744); behavior is driven by cfg flags, plus
# TRAIN.FREEZE_CONV_BODY / MODEL.RPN_ONLY implied by some names.
_TYPE_ALIASES = {"rfcn": "rfcn", "rpn": "rpn"}
for _t in (
    "fast_rcnn", "faster_rcnn", "mask_rcnn", "keypoint_rcnn",
    "mask_and_keypoint_rcnn", "fast_rcnn_frozen_features",
    "mask_rcnn_frozen_features", "keypoint_rcnn_frozen_features",
    "VGG_CNN_M_1024_fast_rcnn", "VGG16_fast_rcnn", "ResNet50_fast_rcnn",
    "ResNet101_fast_rcnn", "ResNet50_fast_rcnn_frozen_features",
    "ResNet101_fast_rcnn_frozen_features", "VGG16_faster_rcnn",
    "ResNet50_faster_rcnn", "ResNet101_faster_rcnn",
):
    _TYPE_ALIASES[_t] = "generalized_rcnn"
for _t in (
    "fpn_rpn", "rpn_frozen_features", "fpn_rpn_frozen_features",
    "VGG_CNN_M_1024_rpn", "VGG16_rpn", "ResNet50_rpn_conv4",
    "ResNet101_rpn_conv4", "VGG_CNN_M_1024_rpn_frozen_features",
    "VGG16_rpn_frozen_features", "ResNet50_rpn_conv4_frozen_features",
    "ResNet101_rpn_conv4_frozen_features",
):
    _TYPE_ALIASES[_t] = "rpn"
for _t in ("ResNet50_rfcn", "ResNet101_rfcn"):
    _TYPE_ALIASES[_t] = "rfcn"


def assert_and_infer_cfg(cfg: Config) -> Config:
    """Validate cross-field invariants (ref: config.py:1064-1084) and
    normalize deprecated MODEL.TYPE spellings."""
    mt = cfg.MODEL.TYPE
    if mt in _TYPE_ALIASES and _TYPE_ALIASES[mt] != mt:
        model = replace(cfg.MODEL, TYPE=_TYPE_ALIASES[mt])
        if mt.startswith("mask_rcnn") and not cfg.MODEL.MASK_ON:
            model = replace(model, MASK_ON=True)  # incl. _frozen_features
        if mt.startswith("keypoint_rcnn") and not cfg.MODEL.KEYPOINTS_ON:
            model = replace(model, KEYPOINTS_ON=True)
        if mt == "mask_and_keypoint_rcnn":
            model = replace(model, MASK_ON=True, KEYPOINTS_ON=True)
        cfg = replace(cfg, MODEL=model)
        if "frozen_features" in mt and not cfg.TRAIN.FREEZE_CONV_BODY:
            cfg = replace(
                cfg, TRAIN=replace(cfg.TRAIN, FREEZE_CONV_BODY=True)
            )
    if cfg.RETINANET.RETINANET_ON:
        if not cfg.FPN.FPN_ON:
            raise ConfigError("RetinaNet requires FPN")
        if cfg.MODEL.NUM_CLASSES < 2:
            raise ConfigError("MODEL.NUM_CLASSES must be set (includes background)")
    if cfg.MODEL.TYPE == "distillation" and not cfg.DISTILLATION.DISTILLATION_ON:
        cfg = replace(
            cfg, DISTILLATION=replace(cfg.DISTILLATION, DISTILLATION_ON=True)
        )
    return cfg


def load_cfg(yaml_path: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """Build a Config from defaults + optional YAML + optional CLI overrides."""
    cfg = Config()
    if yaml_path:
        cfg = merge_cfg_from_file(cfg, yaml_path)
    if opts:
        cfg = merge_cfg_from_list(cfg, opts)
    return assert_and_infer_cfg(cfg)


def get_output_dir(cfg: Config, training: bool = True) -> str:
    """Output directory for checkpoints/results (ref: config.py:1087)."""
    tag = "train" if training else "test"
    datasets = cfg.TRAIN.DATASETS if training else cfg.TEST.DATASETS
    ds = ":".join(datasets) if datasets else "unknown"
    out = os.path.join(cfg.OUTPUT_DIR, tag, ds)
    return out
