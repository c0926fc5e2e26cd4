#!/usr/bin/env python3
"""Smoke run of sad_tpu_torch on one CUDA card: build the kernels, check each
against its plain PyTorch version, and drive the RetinaNet serving path, the
joint SAD training step, Fast / Faster / Mask / Keypoint R-CNN serving, the Fast /
Faster / Mask / Keypoint R-CNN training step, the single-scale family (Faster /
Mask R-CNN R-50-C4, VGG16, R-FCN with OHEM: serving, training, test_net), the training workflow (pseudo-labels,
train_net, checkpoints, resume), the evaluation path (test_net, the COCO, VOC,
Cityscapes and VID evaluators, test-time augmentation, RPN-only proposals and
the two-stage workflow), the serving export (torch.export, reloaded in a
process of its own) and the paper's R-101 <- X-101-64x4d pair at scale 500 end
to end.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--groups 4] [--iters 10] [--warmup 3]

Run from the root of the repository, on a machine with one NVIDIA Hopper
card, nvcc and PyTorch built for CUDA. Inputs and weights are made from
--seed in memory; nothing is read from disk but the repository. Phases, one
line each (name, what was checked, time):

  env            card name and power limit (nvidia-smi), torch / CUDA
                 versions, TF32 switches, kernel build time
  nms_kernel     csrc/nms.cu (sort, IoU bitmask, sweep; the argmax loop for
                 problems over the sort's cap) against ops.nms.nms_multi_plain
                 on the card: idx and valid exactly equal on every case (ties,
                 -0.0 / +0.0 ties, invalid tails, K = max_out, every problem
                 over the cap, one of three over it); median times of both at
                 the RetinaNet decode shape (N=8, K=5000, max_out=100), the RPN
                 shape (N=40, K=1000, max_out=1000, thr 0.7), the training RPN
                 shape (N=40, K=2000, max_out=2000, thr 0.7), the R-CNN decode
                 shape (N=8, K=80000, max_out=100) and over the cap, each beside
                 the argmax loop's earlier time
  roi_align_kernel
                 csrc/roi_align.cu's forward against the plain twin of
                 ops/roi_align.py on the card, float32 and bfloat16: every
                 case bit-equal (the two add the same products in the same
                 order) and within the tolerance (float32 1e-5 * max|ref| +
                 1e-6; bfloat16 one ulp, 2^-7 of the larger magnitude): the
                 box shape (R=8000, res 7) and the mask shape (R=800, res 14)
                 on the four levels of a batch of 8 800x1344 canvases at
                 C=256, rois of every level, two runs of the box shape
                 bit-equal; rois wholly outside the map, zero-area rois,
                 extreme aspect ratios, rois on the last row and column,
                 invalid slots, an odd R, C=64, C=3 and C=20 (the scalar
                 instances), a 1x2 top level, sr 1 and 3; rois wider than the
                 staging buffer (the whole 200x336 P2 map at res 7, 14 and 28:
                 bands, and column chunks at 28); 600 rois on one image and
                 level; C=1 at res 28 over 200x336 rasters; rois whose sample
                 positions fail to grow (past 2^19 cells of a map over 2^20
                 wide: two slots a tap), C=1 and 64; CUDA-event medians,
                 bytes moved and the bound at both shapes
  roi_align_bwd_kernel
                 the backward gather of csrc/roi_align.cu against
                 multilevel_roi_align_bwd_plain on the card, through its
                 wrapper and through autograd (with a cotangent that is a
                 non-contiguous view), on the cases above plus rois over many
                 map tiles (the canvas on P5 and on P2) and 600 rois on one
                 cell; float32 within 1e-5 * max|ref| (1e-4 for the 600),
                 bfloat16 one ulp (2^-7 of the larger magnitude) more: the two
                 add in other orders, so they are not bit-equal, but two runs
                 of the kernel are; median times of both, and of the forward,
                 at the box shape (R=4096, res 7) and the mask shape (R=1024,
                 res 14) of the training step, beside the atomic scatter's
                 earlier time; bytes moved and the bound
  student_infer  R-50-FPN student config, random bf16 weights, a batch of
                 uint8 640x1024 canvases through make_inference_fn; output
                 shapes, finite boxes, classes in 1..80, NMS kernel launched,
                 and detections equal to a decode of the same per-level
                 outputs with the plain NMS on the card; imgs/s
  teacher_infer  the same for the R-101-FPN teacher config (the forward and
                 decode of pseudo-labelling)
  cls_loss_kernels
                 csrc/cls_losses.cu (forward and backward) against the plain
                 twin of ops/fused_losses.py on the card: the 5 flagship
                 levels at bs 8 with G=4, a row count that is no multiple of a
                 block, G=1, an ignored label that is a class, |x| > 90 (the
                 FLT_MIN clamp), beta=0.5, non-integer gammas, PowSum off,
                 C=20 (16-byte chunks), C=9 (the scalar instance), x and pt
                 4 bytes off a 16-byte boundary (the scalar instance; the
                 library refuses the 16-byte one), pt log-uniform in
                 1e-6..1e-3 (where PowSum's MUFU ex2/lg2 err most);
                 per-group sums within 1e-5 relative (summation order: the
                 kernel sums in double, the twin in float) and dx within
                 1e-5 * max|dx| (ulp-level differences of exp/log/pow), and
                 two runs of each kernel bit-equal; CUDA-event medians of
                 both kernels and of the twin at P3, beside the first
                 design's, and the bounds of every level
  cls_loss_levels
                 after the main paths (and last with --only): the device
                 time of both kernels at every level from torch.profiler,
                 beside its bound
  roi_align_device
                 after the main paths: the RoIAlign forward's device time
                 (torch.profiler) at the box and mask shapes of serving and
                 training, the mask-target crop, and on the rois the two
                 training steps sampled; the earlier kernel's on other rois
                 of the same shapes beside them in the phase's line
  joint_step     the R-50 student and the frozen R-101 teacher at full width,
                 --groups x 2 images on the 640x1024 canvas, bf16 compute,
                 LR 1e-6: one step with the kernels and one with the plain
                 twin from the same state (metrics within 1e-5 relative, the
                 gradients of the 5 levels' cls logits within 1e-5 * max),
                 then warm-up + timed steps: finite losses, every trainable
                 tensor updated (non-zero momentum) and at least 90 % of them
                 changed, frozen tensors and the teacher bit-identical,
                 5 + 5 kernel launches a step, one of each at each level's
                 shape; imgs/s

  faster_rcnn_infer, mask_rcnn_infer
                 the two R-50-FPN R-CNN configs, random bf16 weights with the
                 output layers rescaled (tools/profile_infer.spread_rcnn_
                 outputs), a batch of uint8 800x1344 canvases through
                 make_rcnn_inference_fn: shapes, finite boxes, classes in
                 1..80, the RPN fills its 1000 slots, at least 50 of an
                 image's 100 slots valid, mask probabilities in [0, 1];
                 detections (and masks) equal to a run of the same model with
                 the plain NMS and plain RoIAlign in place of the kernels;
                 2 NMS launches and 1 (Faster) or 2 (Mask) RoIAlign launches
                 a batch; imgs/s

  faster_rcnn_train, mask_rcnn_train
                 the training step of the same two configs at full width and
                 depth, --groups x 2 images on the 800x1344 canvas, bf16
                 compute, float32 parameters, LR 1e-6
                 (tools/profile_train.seeded_rcnn_train_step): from one state
                 and one set of sampler uniforms a step with the kernels and
                 a step with the plain NMS and plain RoIAlign (forward and
                 backward) in their place, metrics within 1e-4 relative; the
                 gradients each RoIAlign backward hands to the FPN outputs
                 within one bf16 ulp + 1e-5 * max; the backward kernel timed
                 on the rois the step sampled (and the forward, on the device
                 in roi_align_device); the mask-target crop bit-equal to the
                 plain twin; then warm-up + timed steps:
                 finite losses, loss_mask for Mask R-CNN, every trainable
                 tensor updated, frozen tensors bit-identical, at least one
                 fg roi an image, and a step's launches: NMS 1, RoIAlign
                 forward 1 (Faster) or 3 (Mask: box, mask, and the mask
                 target crop, which carries no gradient), backward 1 or 2;
                 imgs/s, peak memory
  keypoint_rcnn_infer
                 after mask_rcnn_infer: Keypoint R-CNN R-50-FPN
                 (e2e_keypoint_rcnn_R-50-FPN.yaml, one foreground class, the
                 8 x 3x3 conv tower at 512) with the checks of
                 mask_rcnn_infer, kps_heatmaps (B, 100, 56, 56, 17) finite and
                 within one bf16 ulp of the plain-twin run, 2 NMS and 2
                 RoIAlign (box, keypoint) launches a batch; imgs/s, each
                 stage's device ms (CUDA events: RoIAlign and the keypoint
                 head apart), and the detection NMS at its own shape (8 x
                 1000 -> 100) on the batch's candidates: kernel against the
                 plain NMS, both timed, and the bound
  keypoint_rcnn_train
                 after mask_rcnn_train: the checks of mask_rcnn_train for
                 Keypoint R-CNN (loss_kps; the keypoint RoIAlign backward's
                 FPN-output gradients held to the plain one; the backward
                 timed on the step's own keypoint rois, res 14), launches NMS
                 1, RoIAlign forward 2 and backward 2 a step; each stage's
                 device ms (profile_train.rcnn_stage_ms)

  sad_train_loop after the R-CNN training step, in a temporary directory:
                 a synthetic COCO (48 labeled, 48 unlabeled images, sides
                 480-800); the R-101 teacher (random bf16 weights) writes
                 pseudo-labels (its top 10 an image) over the unlabeled split
                 at the score where every image keeps a box (both passes under deterministic
                 cuDNN), registered as the unlabeled stream; train_net
                 trains the R-50 student with it at bs 8 (G = 4), the
                 profile_train settings, 40 iterations, snapshots at 16 and
                 32, 6 loader processes, torch.profiler over iterations
                 36..38: batches labeled / pseudo-labeled by parity,
                 model_iter15/31, model_final, stats.jsonl, cfg.yaml, every
                 loss finite, one cls-loss fwd and bwd launch a level a step
                 and no other kernel; a second invocation a no-op; then,
                 under deterministic cuDNN, an 8-iteration run and a run
                 resumed in a fresh directory from its model_iter3.pkl end
                 bit-equal. Prints the loop's imgs/s over iterations 17..30
                 and 3..14 (which draw on the queue the loader prefilled),
                 from the median iteration and from the window's time, beside the same configuration's step on
                 one prebuilt batch, host ms to build a batch, prefetch copy
                 ms, the share of steps that waited on the loader, queue
                 depth, device idle share over the profiled iterations and
                 peak memory
  mask_rcnn_train_loop
                 Mask R-CNN R-50-FPN through train_net on the same data, 16
                 iterations, a snapshot at 8: the same files and checks,
                 launches NMS 1, RoIAlign forward 3 and backward 2 a step, a
                 second invocation a no-op; under deterministic cuDNN a
                 4-iteration run and one resumed from its model_iter1.pkl
                 bit-equal; imgs/s and the feed
  test_net       the evaluation path through test_net, on a synthetic COCO
                 val split (32 images, sides 480-800) in the same temporary
                 directory: its own ground truth as detections scores bbox
                 and segm AP 1.0; the R-50 student (whole split) and Mask
                 R-CNN R-50-FPN (output layers spread as in mask_rcnn_infer,
                 --range 0 8), seeded random weights saved as native pickles
                 and loaded through --weights: results.json holds the 12 bbox
                 metrics (and the 12 segm_ ones), all finite; bbox_results.json
                 and results.json byte-identical to a run with the plain NMS
                 and RoIAlign in place of the kernels; launches NMS 1 a batch
                 (student), NMS 2 and RoIAlign 2 a batch (Mask); the
                 EXPECTED_RESULTS gate raising on AP 0.99 with tolerance 0.
                 Prints each model's dataset imgs/s (images over the wall time
                 of run_inference_on_roidb) beside its reused-batch imgs/s,
                 the host split in ms a batch (load + resize, copy + device +
                 copy back, mask gather, paste, RLE, dict building), the
                 evaluations' seconds, and the device's idle share over the
                 inference loop (torch.profiler kernel time of a second,
                 profiled loop over the unprofiled wall)
  keypoint_test_net
                 after test_net: a synthetic keypoint split (16 images, one
                 category, 5 keypoints with a flip map); test_net with the
                 keypoint config (output layers spread, --range 0 8): results
                 with the 10 keypoints_ metrics, finite, bbox_results.json
                 (with keypoint triplets) and results.json byte-identical to
                 the plain-twin run, NMS 2 and RoIAlign 2 a batch, the host
                 split with the heatmap copy and the host decode in ms a
                 batch; then train_net 8 iterations on the split (snapshot
                 at 3, loss_kps in stats.jsonl, NMS 1, RoIAlign 2 + 2 a step)

  fast_rcnn_infer
                 after keypoint_rcnn_infer: Fast R-CNN R-50-FPN
                 (fast_rcnn_R-50-FPN.yaml, no RPN) on 2000 seeded proposals an
                 image spread over its content, bs 8 on 800x1344: the checks
                 of faster_rcnn_infer, detections equal to the plain-twin run;
                 the RoIAlign forward at R = 16,000 res 7 bit-equal to the plain
                 twin; the detection NMS at 8 x 160,000 -> 100 on the batch's
                 own candidates exactly equal to the plain NMS, with its path
                 (sorted, or the argmax loop over 8192 valid) and valid counts;
                 1 NMS and 1 RoIAlign launch a batch; imgs/s, stage ms
                 (backbone, RoI levels, RoIAlign, box head, decode, NMS) and
                 the device's idle share
  fast_rcnn_train
                 after keypoint_rcnn_train: the checks of faster_rcnn_train for
                 the Fast R-CNN step on those proposals (G = 4): no NMS, RoIAlign
                 forward 1 and backward 1 a step, no RPN losses, the backward's
                 FPN-output gradients held to the plain one, the backward timed
                 on the step's own rois beside its plain twin and bound
  proposal_pipeline
                 after keypoint_test_net, the two-stage workflow on the first 8
                 landscape images of smoke_val (one batch):
                 test_net with rpn_R-50-FPN.yaml (seeded weights, RPN outputs
                 spread) writes rpn_proposals.pkl, equal to a plain-NMS run's,
                 and its AR; the RPN-only NMS at 40 x 1000 -> 2000 held to its
                 twin (slots past the 1000 candidates invalid); train_net with
                 fast_rcnn_R-50-FPN.yaml on that file (TRAIN.PROPOSAL_FILES), 8
                 iterations; test_net on TEST.PROPOSAL_FILES from
                 its model_final, byte-identical to the plain-twin run;
                 launches counted for each
  tta_test_net   test_net --range 0 8 with e2e_mask_rcnn_R-50-FPN_tta.yaml (box
                 and mask TTA, box voting), the same with soft-NMS, and Keypoint
                 R-CNN with the KPS_AUG overrides (SCALE_SIZE_DEP) on smoke_kps,
                 each cut to two of the eight TTA scales (500, and 1100 clamped
                 to the canvas): 6 box and 6 mask passes, 5 keypoint passes:
                 byte-identical to the plain-twin runs, launches a pass, the
                 dataset imgs/s and timing.json's split of passes, host merge
                 and aux passes, the device's idle share

  c4_rcnn_infer  after the device-time phases, like the single-scale phases below
                 (two lines, c4_faster_rcnn_infer and c4_mask_rcnn_infer): the
                 single-scale Faster and Mask R-50-C4 YAMLs (res5 box head,
                 v0upshare), bs 8 on 800x1344, bf16, spread random weights,
                 through make_rcnn_inference_fn: shapes, finite, classes in
                 1..80, mask_prob (8, 100, 14, 14, 81) in [0, 1]; detections
                 and masks equal to the plain-twin run; the RPN NMS (8 x 6000
                 -> 1000, sorted) and the decode NMS (8 x 80,000 -> 100) on
                 the batch's own candidates exactly equal to the plain NMS;
                 the one-level RoIAlign forward at R = 8000, res 14, C = 1024
                 on the 50x84 res4 map, rois wider than the staging buffer,
                 and the cascaded mask's R = 800, each bit-equal to the plain
                 twin and timed beside its bound; 2 NMS and 1 (Faster) or 2
                 (Mask) RoIAlign launches a batch; imgs/s, stage device ms
                 (body, RPN, RoIAlign, res5 head, decode, cascade) and idle
  c4_rcnn_train  the Mask R-50-C4 step (v0upshare), 8 groups of 1 image (the
                 reference's 8 GPUs x IMS_PER_BATCH 1): a kernel step and a
                 plain-twin step from one state and one set of sampler
                 uniforms (metrics within 1e-5 relative), the training RPN NMS
                 at 8 x 12,000 -> 2000 on the step's own candidates (every
                 problem over the sort's 8192 cap: the argmax loop; its path
                 printed), the RoIAlign backward's trunk gradients within
                 1e-5 * max + one bf16 ulp of the plain backward's and two
                 runs bit-equal, the backward and forward on the step's rois
                 (R = 4096, res 14, C = 1024) and the mask target crop timed;
                 warm-up + timed steps (NMS 1, RoIAlign forward 2, backward 1
                 a step), every trainable tensor updated, frozen ones
                 bit-identical; imgs/s, peak memory, stage ms, idle; then the
                 v0up head (its own res5 on the fg rois) with the same checks
                 and one main-path step (NMS 1, forward 3, backward 2)
  vgg16_rcnn     (vgg16_rcnn_infer, vgg16_rcnn_train) VGG16 Faster R-CNN on
                 608x1024: serving with the checks of c4_rcnn_infer (RPN 8 x
                 6000 -> 300, decode 8 x 24,000 -> 100, RoIAlign R = 2400, res
                 7, C = 512) and one training step with those of c4_rcnn_train
                 (the argmax loop at 8 x 12,000 -> 2000); the RoIAlign forward
                 at VGG_CNN_M_1024's shape (C = 1024, res 7) on a seeded map
  rfcn_ohem      (rfcn_ohem_infer, rfcn_ohem_train) R-FCN R-101 with OHEM on
                 608x1024: serving (PSRoIPool in plain PyTorch, no RoIAlign
                 launch; the NMS shapes of vgg16_rcnn), and the step with
                 OHEM: each image keeps OHEM_ROI_PER_IMG = 128 of its 300 live
                 rois, metrics of the kernel and plain-twin steps equal
  c4_test_net    test_net --range 0 8 with the Mask
                 R-50-C4 YAML on smoke_val (seeded spread weights through
                 --weights): boxes and RLE masks evaluated (24 finite
                 metrics), results byte-identical to the plain-twin run, NMS 2
                 and RoIAlign 2 launches a batch, the host split and idle

  export_serving after c4_test_net: the R-50 student's serving (device
                 normalisation, model, decode) exported with torch.export at bs 8 on
                 640x1024 (eval/export.py), the .pt2 reloaded and served in a child
                 process that imports torch and sad_tpu_torch.eval.export only: classes
                 and valid equal to live serving, boxes and scores bit-equal or within
                 1e-5 x max|live| (the line says which), one NMS kernel launch a call of
                 the exported program (the custom op sad_tpu_torch::nms_multi), live
                 serving after the export unchanged; imgs/s of both, and the host ms to
                 enqueue a batch beside its wall for both loaded in this process; the
                 decode NMS (8 x 5000 -> 100) on the batch's own candidates against the
                 plain NMS; host microseconds a call through the custom op and through
                 nms_cuda
  voc_test_net   a seeded VOC2007 devkit (16 JPEGs 500x375, 1-6 objects of the 20
                 classes, some difficult) converted by VOCDataset.as_coco_gt; its ground
                 truth as detections mAP 1.0; test_net with faster_rcnn_VGG16_voc07.yaml
                 (seeded spread weights through --weights): the VOC07 11-point per-class
                 APs and mAP, byte-identical to the plain-twin run, NMS 2 and RoIAlign 1
                 a batch; TEST.FORCE_JSON_DATASET_EVAL gives the COCO keys; on the split's
                 first 8 images the RPN NMS (8 x 6000 -> 300), the decode NMS (8 x 6000
                 -> 100) and the box RoIAlign (R = 2400, res 7, C = 512) held to their
                 twins and timed; dataset imgs/s, ms a batch, idle
  cityscapes_test_net
                 a seeded gtFine val tree (8 PNGs 2048x1024, the 8 instance classes plus
                 crowd, non-instance and degenerate polygons) through
                 tools/convert_cityscapes_to_coco; its ground truth as detections bbox
                 and segm AP 1.0; test_net with e2e_mask_rcnn_R-50-FPN_cityscapes.yaml on
                 the 1024x2048 canvas: a pred.txt an image and a PNG a detection, the 24
                 bbox and segm metrics finite, NMS 2 and RoIAlign 2 a batch; the served
                 batch equal to the plain-twin run; the RPN NMS (40 x 1000 -> 1000), the
                 decode NMS (8 x 8000 -> 100), the box (R = 8000) and mask (R = 800, res
                 14) RoIAlign held to their twins and timed; ms a batch, host split, idle
  vid_test_net   the R-50 student through test_net --range 0 16 on smoke_val registered
                 as vid_smoke_val: its ground truth as detections VID AP 1.0, the VID
                 protocol's 12 metrics, byte-identical to the plain-twin run

  cls_loss_kernels_500
                 with the kernel checks: the cls-loss kernels against their
                 plain twin at the 5 levels of the scale-500 pair's 512x896
                 canvas (P3 516,096 rows x 80 at bs 8, G=4), the same bounds;
                 P3 timed; device times per level last, in cls_loss_levels_500
  label_assign   after test_net, on the host: the native float32 assignment
                 pass (sad_tpu_torch/native, built by g++ from the checkout)
                 bit-equal to its numpy float32 twin on the 48 labeled images
                 of the synthetic COCO at both canvases (640x1024 at scale
                 600, 512x896 at 500), on the minibatch builder's assignment
                 grid; ms an image of the pass, the twin and the whole
                 assign_retinanet_labels; the images where a float64 pass
                 would tie other anchors
  x101_teacher_infer
                 the X-101-64x4d-FPN teacher (64 groups of width 4, FOLD_AFFINE)
                 at full width, bs 8 on 512x896, random bf16 weights: the
                 checks of teacher_infer (decode equal to the plain-NMS one),
                 NMS launches (and no other kernel), imgs/s, kernel ms a batch
                 by category, idle share, peak memory
  joint_step_500 the R-101 student and the frozen X-101 teacher of the scale-500
                 YAMLs, bs 8 (G=4) on 512x896: the checks of joint_step (a
                 kernel step against a plain-twin step, one launch of each
                 cls-loss kernel at each of the 5 new level shapes a step),
                 imgs/s, kernel ms a step by category, peak memory
  fold_affine    FOLD_AFFINE on against off, the same weights in one process
                 (seeded AffineChannel values away from s = 1, b = 0): the
                 R-50 student's serving (bf16 model; per-level outputs
                 within 0.05 of the unfolded output's max) and the R-50 +
                 R-101 joint step (first-step metrics within 1e-2 relative);
                 imgs/s of each, timed off/on/on/off, and elementwise kernel
                 ms beside all kernel ms (torch.profiler)
  softmax_step   a seeded R-50 RetinaNet step with RETINANET.SOFTMAX at full
                 width, bs 8: each level's softmax focal loss within 1e-5 of
                 the levels' sum and its cls-logit gradients within 1e-5 of the
                 largest, against the float64 formula on the card,
                 then warm-up + timed steps (finite, every trainable tensor
                 updated, no kernel of ours launched); imgs/s

  ddp_joint_step last, after the device-time phases: data parallelism,
                 W = max(2, cards) ranks, each a process of its own
                 (parallel.launch.spawn,
                 torchrun's environment; NCCL with a card a rank, else the
                 ranks share cuda:0 over gloo and the line says so): the
                 R-50 <- R-101 joint step at full width, bs --groups x 2 on
                 640x1024, float32 with TF32 off and PyTorch's own
                 convolutions (cuDNN's float32 convolutions do not sum a
                 batch of 4 as one of 8: tools/profile_ddp's witness), on W
                 ranks of G / W groups against one process (a
                 world of 1 over NCCL, the training code's default) from the
                 same seeded state and batch: after 2 steps every metric
                 within 1e-5 relative, the worst
                 parameter tensor within 1e-5 relative L2, parameters and
                 momenta bit-equal across the ranks, one cls-loss forward
                 and backward a level a step on each rank at its row count;
                 then 3 timed steps (DDP_TIMED_STEPS): each rank's step ms, the gradient
                 all-reduce's ms (CUDA events) and bytes, host CPU s a step
  ddp_rcnn_step  the same for the Mask R-CNN R-50-FPN step on 800x1344, each
                 rank taking its rows of the sampler's global draws: 2 steps,
                 metrics and parameters held to 1e-5 after the first (at the
                 second a proposal near a tie flips with the first update's
                 last bits; printed), ranks bit-equal and every rank's
                 sampler generator in the one process's state after both;
                 NMS 1, RoIAlign forward 3 and backward 2 a step on each rank
  ddp_test_net   test_net --multi-gpu-testing over smoke_val (both
                 orientations) with the R-50 student's seeded weights, and
                 --pseudo-out (top 10 an image): the merged bbox_results.json
                 and pseudo.json hold the one process's detections in its
                 order (scores within 1e-5, boxes within 1e-3 px, annotation
                 ids equal), results.json beside; NMS one a batch of each
                 rank's shard
  ddp_train_loop train_net on W ranks over smoke_lab and ddp_test_net's
                 pseudo-labels, bs 8, 8 iterations, a snapshot after 3,
                 deterministic cuDNN: rank 0's files only, one stats series,
                 cls-loss launches on every rank at its rows, ranks
                 bit-equal, and a W-rank run resumed from model_iter3.pkl in
                 a fresh directory bit-identical; iteration ms and CPU ms by
                 rank

  spatial_infer  last: sad_tpu's 'model' mesh axis (parallel/mesh.py, spatial.py,
                 halo.py), two ranks, each a process of its own (a card a rank over
                 NCCL, else both on cuda:0 over gloo with the halo rows staged through
                 pinned host memory; the line names the layout and the transport): the
                 R-50 student at full width, bs --batch on 640x1024, height-sharded over
                 n_model = 2 (P7's 5 rows split 3 / 2), through make_inference_fn(cfg,
                 model, mesh) at float32 with TF32 and cuDNN off, against one process's
                 serving on the first rank: each level's gathered cls_prob and bbox_pred
                 within 1e-5 x max, classes and valid equal, boxes and scores within
                 1e-5 x max; the NMS kernel once a batch on the first rank, never on the
                 other; 3 timed batches with cuDNN (SPATIAL_TIMED): forward, halo (ms,
                 bytes), gather and batch ms by rank, peak memory against one process;
                 the decode NMS on the gathered batch's candidates against the plain NMS
  spatial_joint_step
                 the R-50 <- R-101 joint step at full width, bs 4 (G = 2) on 640x1024, on
                 a 2 x 2 mesh (sad_tpu's dryrun phase-2 layout: every loss group spans
                 two ranks; the normalizers reduced over the ranks), 4 ranks, against one
                 process from the same seeded state and batch: 2 steps at float32, TF32
                 and cuDNN off, metrics within 1e-5 relative, every parameter tensor
                 within 1e-5 relative L2 or, beyond it, its relative L2 error against one
                 process's float64-compute run within 2x the worst of one process's
                 float32 step there (SPATIAL_F64_FACTOR; the phase names each such
                 tensor), parameters and momenta bit-equal across the
                 ranks, one cls-loss forward and backward a level a step at each rank's
                 band rows; 3 timed steps with cuDNN: step, halo (ms, bytes) and gradient
                 all-reduce ms by rank, peak memory; the same 2 steps at float64 compute
                 against one process's, metrics and parameters within 1e-5; the
                 cls-loss kernels against their twin on the first rank's band of P3
                 (92,160 rows, a group an image)
  multislice_joint_step
                 sad_tpu's multislice ('dcn') mesh: the R-50 <- R-101 joint step at full
                 width, bs 4 (G = 2) on 640x1024, over 4 ranks as 2 nodes x 2 (torchrun's
                 environment through launch.spawn(nodes=2); create_multislice_mesh(): one
                 image a rank, each loss group over a node's two ranks, the gradients
                 summed in the node and then across nodes), against one process: 2 steps
                 at float32, TF32 and cuDNN off in every rank, held as spatial_joint_step
                 holds its step; parameters and momenta bit-equal across the 4 ranks after
                 every step; one cls-loss forward and backward a level a step on each rank
                 at its image's rows; 3 timed steps with cuDNN (MULTISLICE_TIMED) and as
                 many instrumented: step ms by rank, the node-level and cross-node ms and
                 bytes of the two-level sum beside a flat all-reduce of the same gradients
                 on the same ranks, the count all-reduce's ms; the cls-loss kernels against
                 their twin on the first rank's P3 (92,160 rows, G = its one image)
  span_train_loop
                 train_net with the Mask R-CNN R-50-FPN YAML over smoke_lab on 4 ranks as
                 2 nodes x 2, NUM_GPUS = 2, TRAIN.IMS_PER_BATCH = 2 (4 images, one a rank:
                 each R-CNN loss group over a node's two ranks), 4 iterations with a
                 snapshot after iteration 2 at float32 on PyTorch's own convolutions
                 (TF32 and cuDNN off: an image's forward does not depend on its batch,
                 so the counts are held exactly), then a 4-rank run
                 resumed in a fresh directory from model_iter2.pkl: rank 0's files only,
                 ranks bit-equal, the resumed run bit-equal to the uninterrupted one, NMS
                 1, RoIAlign forward 3 and backward 2 a step on each rank, the first
                 step's per-group counts equal to one process's first iteration exactly;
                 the NMS and RoIAlign kernels against their twins on the first rank's own
                 inputs (5 RPN problems -> 2000, its 512 box rois), timed after an L2 flush

Then a JSON line with every kernel of the paths (with the loops' launches
as train_loop_launches, the evaluation's as test_net_launches, Keypoint
R-CNN's share as keypoint_launches, keypoint_test_net_launches and
keypoint_train_loop_launches, and each
rank's launches in the data-parallel phases as ddp_launches,
ddp_train_loop_launches and ddp_test_net_launches), the
card's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failure
raises and the exit code is not 0; without a CUDA card the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
STUDENT_CFG = "sad_tpu_torch/configs/retinanet_R-50-FPN_student.yaml"
TEACHER_CFG = "sad_tpu_torch/configs/retinanet_R-101-FPN_teacher.yaml"
# the paper's second experiment: R-101 student <- X-101-64x4d teacher at scale 500
STUDENT_500_CFG = "sad_tpu_torch/configs/retinanet_R-101-FPN_student_500.yaml"
TEACHER_500_CFG = "sad_tpu_torch/configs/retinanet_X-101-64x4d-FPN_teacher_500.yaml"
FASTER_CFG = "sad_tpu_torch/configs/e2e_faster_rcnn_R-50-FPN.yaml"
MASK_CFG = "sad_tpu_torch/configs/e2e_mask_rcnn_R-50-FPN.yaml"
KEYPOINT_CFG = "sad_tpu_torch/configs/e2e_keypoint_rcnn_R-50-FPN.yaml"
# N problems, K candidates, max_out, threshold
DECODE_SHAPE = (8, 5000, 100, 0.5)  # RetinaNet decode: 8 images, 5 levels x 1000
RPN_SHAPE = (40, 1000, 1000, 0.7)  # R-CNN proposals: 5 levels x 8 images
RCNN_DECODE_SHAPE = (8, 80000, 100, 0.5)  # R-CNN decode: 1000 rois x 80 classes
RPN_TRAIN_SHAPE = (40, 2000, 2000, 0.7)  # R-CNN training proposals: 5 levels x 8 images
RCNN_CANVAS = (800, 1344)
# the card times of the kernels before their redesign (PERF.md section 6, rows #2
# and #8; NVIDIA H100 80GB HBM3, 700.00 W), printed beside the new medians
NMS_EARLIER_MS = {"decode": 0.3069, "rpn": 1.2370, "rpn_train": 3.2288, "rcnn_decode": 3.4746}
ROI_BWD_EARLIER_MS = {"box": 3.0123, "mask": 2.9818}
# device ms of the RoIAlign forward before its redesign (a block a roi's bin
# row) on the rois of sad_tpu_torch/tools/profile_roi_align.py at the same
# shapes (PERF.md section 6, row #7), printed beside the new device times
ROI_FWD_EARLIER_MS = {"box": 0.4639, "mask": 0.1383, "box_train": 0.2470, "mask_train": 0.1745}


def _phase(name: str, checked: str, seconds: float) -> None:
    print(f"[{name}] {checked} ({seconds:.3f} s)", flush=True)
    # a phase ends every process it started (multiprocessing's resource tracker
    # lives to the end of the run); one left is named here and ended at the end
    left = [p for p in _descendants() if p[1] != "Z" and "resource_tracker" not in p[2]]
    if left:
        print(f"chip_smoke: after [{name}] {len(left)} processes still run: {left}",
              file=sys.stderr, flush=True)


def _adopt_orphans() -> bool:
    """Make this process the child subreaper of all it starts (Linux
    prctl PR_SET_CHILD_SUBREAPER, on this process only): a process whose
    parent ends before it is handed to this one and not to init, so that
    ``_end_descendants`` still finds it."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def _descendants() -> list:
    """(pid, state, command line) of every process below this one, from /proc."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        kids.setdefault(int(ppid), []).append((int(d), state, cmd))
    out, todo = [], [os.getpid()]
    while todo:
        for kid in kids.get(todo.pop(), []):
            out.append(kid)
            todo.append(kid[0])
    return out


def _end_descendants(grace_s: float = 5.0) -> list:
    """End every process below this one that still runs (SIGTERM, then
    SIGKILL after ``grace_s``); then multiprocessing's own exit (its
    finalizers, while the resource tracker that the ranks and loaders share
    still runs), the tracker, and whatever is left; reap what was orphaned
    here. Returns what ran, the tracker left out."""
    import signal
    from multiprocessing import resource_tracker, util

    def running():
        return [p for p in _descendants() if p[1] != "Z"]

    def end(procs):
        pids = {pid for pid, _, _ in procs}
        for sig in (signal.SIGTERM, signal.SIGKILL):
            for pid in pids:
                with contextlib.suppress(OSError):
                    os.kill(pid, sig)
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline and any(p[0] in pids for p in running()):
                time.sleep(0.05)

    left = [p for p in running() if "resource_tracker" not in p[2]]
    end(left)
    util._exit_function()
    with contextlib.suppress(Exception):
        resource_tracker._resource_tracker._stop()
    late = running()
    end(late)
    for pid, _, _ in _descendants():
        with contextlib.suppress(OSError):
            os.waitpid(pid, os.WNOHANG)
    return left + late


def _median_ms(torch, fn, iters: int, warmup: int, before=None) -> float:
    """Median of per-call device times from CUDA events; ``before`` (e.g.
    _l2_flush's) runs ahead of each call, outside the timed interval."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nms_case(torch, rng, n, k, clusters=60, invalid_from=None, tie_step=None,
              all_invalid_rows=(), invalid_tail_rows=None, valid_share=None, signed_zeros=False):
    """Clustered boxes on a 1024x640 canvas so real suppression happens."""
    centers = rng.uniform(0, [1024, 640], (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], axis=1) + rng.uniform(-12, 12, (n, k, 2))
    wh = rng.uniform(8, 120, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (n, k)).astype(np.float32)
    if tie_step:
        scores = (np.round(scores / tie_step) * tie_step).astype(np.float32)
    if invalid_from is not None:
        scores[:, invalid_from:] = np.float32(-1e30)
    for r in all_invalid_rows:
        scores[r] = np.float32(-1e30)
    if invalid_tail_rows is not None:
        rows, start = invalid_tail_rows
        scores[list(rows), start:] = np.float32(-1e30)
    if valid_share is not None:
        scores[rng.uniform(size=(n, k)) > valid_share] = np.float32(-1e30)
    if signed_zeros:  # exact +0.0 and -0.0 among negative and positive scores
        scores -= np.float32(0.5)
        pick = rng.uniform(size=(n, k))
        scores[pick < 0.25] = np.float32(0.0)
        scores[pick > 0.75] = np.float32(-0.0)
    dev = "cuda"
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


def _nms_bound(n, k, max_out, valid):
    """NMS on this run's data: each problem takes one step per kept box (and
    one more that finds nothing live, unless max_out came first), each step
    an IoU (~15 operations) per candidate; bytes: boxes and scores read once,
    idx and valid written once."""
    steps = int(valid.sum()) + int((~valid.all(dim=1)).sum())
    return bound(n * k * 20 + n * max_out * 5, 15 * k * steps)


def phase_nms(torch, rng, iters, warmup):
    from sad_tpu_torch.ops import nms, nms_kernel

    t0 = time.perf_counter()
    n, k, max_out, thr = DECODE_SHAPE
    rn, rk, rmax, rthr = RPN_SHAPE
    dn, dk, dmax, dthr = RCNN_DECODE_SHAPE
    tn, tk, tmax, tthr = RPN_TRAIN_SHAPE
    cases = {
        "decode N=8 K=5000 thr=0.5": (_nms_case(torch, rng, n, k, invalid_from=4600), thr, max_out),
        # a level's 1000 candidates of one image; the last 8 problems are the
        # coarsest level's, 819 anchors padded to K with NEG_INF
        "rpn N=40 K=1000 max_out=1000 thr=0.7": (
            _nms_case(torch, rng, rn, rk, clusters=200,
                      invalid_tail_rows=(range(32, 40), 819)), rthr, rmax),
        # the training step's proposals: 2000 candidates a level and image
        "rpn train N=40 K=2000 max_out=2000 thr=0.7": (
            _nms_case(torch, rng, tn, tk, clusters=400,
                      invalid_tail_rows=(range(32, 40), 819)), tthr, tmax),
        # 1000 rois x 80 classes, class-offset boxes, ~3 % over SCORE_THRESH
        "rcnn decode N=8 K=80000 thr=0.5": (
            _nms_case(torch, rng, dn, dk, clusters=400, valid_share=0.03), dthr, dmax),
        "N=1 (nms_fixed)": (_nms_case(torch, rng, 1, 3000), 0.5, max_out),
        "K=1500 not a multiple of 1024, thr=0.3": (_nms_case(torch, rng, 3, 1500), 0.3, max_out),
        "invalid tail from 2000, thr=0.7": (_nms_case(torch, rng, 4, 5000, invalid_from=2000), 0.7, max_out),
        "all-invalid problem": (_nms_case(torch, rng, 3, 700, all_invalid_rows=(1,)), 0.5, max_out),
        "fewer valid than max_out": (_nms_case(torch, rng, 2, 300, invalid_from=40), 0.5, max_out),
        "exact score ties": (_nms_case(torch, rng, 8, 5000, tie_step=0.05), 0.5, max_out),
        "-0.0 / +0.0 ties": (_nms_case(torch, rng, 4, 3000, signed_zeros=True), 0.5, 300),
        "K = max_out = 1500, thr 0.7": (_nms_case(torch, rng, 6, 1500, clusters=150), 0.7, 1500),
        # more valid candidates than the order stage sorts: the argmax loop
        "K=20000, all valid: every problem over the sort's cap": (
            _nms_case(torch, rng, 2, 20000, clusters=300), 0.5, max_out),
        "one problem over the cap, two under": (
            _nms_case(torch, rng, 3, 10000, clusters=300, invalid_tail_rows=((1, 2), 3000)),
            0.5, max_out),
    }
    max_err = 0.0
    for name, ((boxes, scores), t, m) in cases.items():
        if name.startswith("N=1"):
            ik, vk = nms.nms_fixed(boxes[0], scores[0], t, m)
            ik, vk = ik[None], vk[None]
        else:
            ik, vk = nms.nms_multi(boxes, scores, t, m)
        ip, vp = nms.nms_multi_plain(boxes, scores, t, m)
        torch.cuda.synchronize()
        if not torch.equal(vk, vp) or not torch.equal(ik, ip):
            bad = int((ik != ip).sum()) + int((vk != vp).sum())
            raise AssertionError(f"nms kernel != plain on case {name!r}: {bad} entries differ")
        if name == "all-invalid problem" and (bool(vk[1].any()) or bool(ik[1].any())):
            raise AssertionError("all-invalid problem emitted a detection")
        max_err = max(max_err, float((ik - ip).abs().max()))
    stats, said = {}, []
    for key, name, plain_iters in (("decode", "decode N=8 K=5000 thr=0.5", iters),
                                   ("rpn", "rpn N=40 K=1000 max_out=1000 thr=0.7", 3),
                                   ("rpn_train", "rpn train N=40 K=2000 max_out=2000 thr=0.7", 2),
                                   ("rcnn_decode", "rcnn decode N=8 K=80000 thr=0.5", iters),
                                   ("over_cap", "K=20000, all valid: every problem over the "
                                    "sort's cap", 1)):
        (boxes, scores), t, m = cases[name]
        ms = _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, t, m), iters * 5, warmup)
        plain_ms = _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, t, m),
                              plain_iters, 1)
        _, valid = nms_kernel.nms_cuda(boxes, scores, t, m)
        b = _nms_bound(*scores.shape, m, valid)
        stats[key] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b}
        earlier = f" (argmax loop of PERF.md row #2: {NMS_EARLIER_MS[key]} ms)" if (
            key in NMS_EARLIER_MS) else ""
        said.append(f"{name}: kernel {ms:.4f} ms{earlier}, plain {plain_ms:.4f} ms, bound "
                    f"{b['bound_ms']:.4f} ms by {b['bound_by']}, {int(valid.sum())} kept")
    _phase("nms_kernel", f"{len(cases)} cases, idx and valid exactly equal to the plain "
           f"version; medians: " + "; ".join(said), time.perf_counter() - t0)
    return stats


# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations an element of the cls-loss kernels, counted from the
# source: two expf and one logf (~20 each with their range reduction), one
# IEEE division (~10), ~30 multiplies/adds for the terms and the masks, and
# for PowSum log2f, exp2f and a multiply (~10); the backward adds ~20
# multiplies/adds
CLS_FWD_OPS, CLS_FWD_POW_OPS, CLS_BWD_OPS = 100, 10, 120
# flagship per-level grids (640x1024 canvas, strides 8..128), A = 9, C = 80
LEVEL_HW = {3: (80, 128), 4: (40, 64), 5: (20, 32), 6: (10, 16), 7: (5, 8)}
# the scale-500 pair's (512x896 canvas)
LEVEL_HW_500 = {3: (64, 112), 4: (32, 56), 5: (16, 28), 6: (8, 14), 7: (4, 7)}
# the card times of the cls-loss kernels at P3 of a bs 8 step before their
# redesign (PERF.md section 6, rows #3 and #5; NVIDIA H100 80GB HBM3, 700.00 W)
CLS_EARLIER_MS = {"fwd": 0.7658, "bwd": 0.6720}


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time of a piece of work on the H100: bytes over the memory
    rate or operations over the float32 rate, whichever is larger."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _cls_case(torch, gen, rows, groups, x_scale=3.0, clamp_rows=0, c=80, offset=0,
              pt_near_zero=False):
    """x, pt (rows, c) float32, labels (rows,) int32 in -1..c, cotangents (G,);
    offset > 0 makes x and pt views that start `offset` floats into their
    buffers (4 * offset bytes off a 16-byte boundary); pt is uniform in
    [0.001, 0.999], or log-uniform in [1e-6, 1e-3] with pt_near_zero (a
    trained teacher's background probabilities)."""
    x = torch.randn((rows * c + offset,), generator=gen, device="cuda")[offset:].view(rows, c)
    x.mul_(x_scale)
    if clamp_rows:
        x[:clamp_rows] = x[:clamp_rows].sign() * (90.0 + 10.0 * x[:clamp_rows].abs())
    pt = torch.rand((rows * c + offset,), generator=gen, device="cuda")[offset:].view(rows, c)
    if pt_near_zero:
        pt.mul_(3.0 * np.log(10.0)).exp_().mul_(1e-6)
    else:
        pt.mul_(0.998).add_(0.001)
    labels = torch.randint(-1, c + 1, (rows,), generator=gen, device="cuda", dtype=torch.int32)
    gf = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    gd = torch.rand((groups,), generator=gen, device="cuda") + 0.5
    return x, pt, labels, gf, gd


def _l2_flush(torch):
    """A write over 256 MiB, five times the H100's 50 MB L2: a call timed
    after it finds none of its inputs in L2, and pays the write-back of an
    L2 full of other lines, as it leaves its own last writes for the next
    kernel to pay."""
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    return buf.zero_


def _cls_bounds(rows, c, groups):
    """The forward's and the backward's bounds with PowSum on: each input read
    once (x, pt, labels; the backward's cotangents), each output written once."""
    n = rows * c
    return (bound(8 * n + 4 * rows + 12 * groups, (CLS_FWD_OPS + CLS_FWD_POW_OPS) * n),
            bound(12 * n + 4 * rows + 8 * groups, CLS_BWD_OPS * n))


def phase_cls_losses(torch, seed, batch, groups, iters, warmup, level_hw=LEVEL_HW,
                     phase="cls_loss_kernels", levels_only=False):
    """The cls-loss kernels against their plain twin at the levels of
    ``level_hw`` and, unless ``levels_only``, at the edge cases."""
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.ops.fused_losses import cls_losses_bwd_plain, cls_losses_fwd_plain

    t0 = time.perf_counter()
    flag = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)  # the flagship config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 9
    # name: rows, G, params, _cls_case keywords, the instance's vec width
    level_of = {f"P{l} bs{batch} G={groups}": l for l in level_hw}
    cases = {name: (batch * level_hw[l][0] * level_hw[l][1] * a, groups, flag, {}, 4)
             for name, l in level_of.items()}
    cases.update({} if levels_only else {
        "rows not a multiple of a block, G=3": (3 * 1013, 3, flag, {}, 4),
        "G=1": (4099, 1, flag, {}, 4),
        "IGNORED_LABEL=5 (a class)": (2 * 3001, 2, flag._replace(ignored_label=5), {}, 4),
        "|x| > 90 (FLT_MIN clamp)": (4 * 2000, 4, flag, {"x_scale": 30.0, "clamp_rows": 4000}, 4),
        "beta=0.5": (2 * 5000, 2, flag._replace(beta_d=0.5), {}, 4),
        "gamma_f=1.5 gamma_d=2.5": (2 * 5000, 2, flag._replace(gamma_f=1.5, gamma_d=2.5), {}, 4),
        "PowSum off": (2 * 5000, 2, flag._replace(want_powsum=False), {}, 4),
        "C=20 (16-byte chunks)": (2 * 4001, 2, flag, {"c": 20}, 4),
        "C=9 (scalar instance)": (3 * 1001, 3, flag, {"c": 9}, 1),
        "x, pt 4 bytes off a 16-byte boundary": (2 * 3001, 2, flag, {"offset": 1}, 1),
        "pt log-uniform in 1e-6..1e-3": (2 * 5000, 2, flag, {"pt_near_zero": True}, 4),
    })
    fwd_err = bwd_err = 0.0
    levels, rels = [], {}
    for name, (rows, g, p, kw, vec) in cases.items():
        x, pt, labels, gf, gd = _cls_case(torch, gen, rows, g, **kw)
        got_vec = K.kernel_instance(x.shape[1], x.data_ptr(), pt.data_ptr(), p)[0]
        if got_vec != vec:
            raise AssertionError(f"cls losses {name!r}: instance of width {got_vec}, want {vec}")
        sums = K.cls_losses_fwd(x, pt, labels, g, p)
        ref = cls_losses_fwd_plain(x, pt, labels, g, p)
        dx = K.cls_losses_bwd(x, pt, labels, gf, gd, p)
        dref = cls_losses_bwd_plain(x, pt, labels, gf, gd, p)
        again = (K.cls_losses_fwd(x, pt, labels, g, p), K.cls_losses_bwd(x, pt, labels, gf, gd, p))
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(ref).all()) and bool(torch.isfinite(dref).all())):
            raise AssertionError(f"cls losses {name!r}: the plain twin is not finite")
        rel = float(((sums - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        if not p.want_powsum and bool(sums[:, 2].any()):
            raise AssertionError(f"cls losses {name!r}: PowSum off but the kernel wrote one")
        drel = float((dx - dref).abs().max() / dref.abs().max())
        rels[name] = (rel, drel)
        if not rel <= 1e-5 or not drel <= 1e-5:
            raise AssertionError(f"cls losses {name!r}: sums rel err {rel:.3e}, dx err "
                                 f"{drel:.3e} of max|dx| (limits 1e-5)")
        if not (torch.equal(sums, again[0]) and torch.equal(dx, again[1])):
            raise AssertionError(f"cls losses {name!r}: two runs of the kernels differ")
        if kw.get("offset"):  # the library refuses 16-byte chunks of an unaligned x
            before = (K.fwd_launches, K.bwd_launches)
            for launch in (lambda: K._launch_fwd(x, pt, labels, g, p, 4, K.GAMMA2_POW),
                           lambda: K._launch_bwd(x, pt, labels, gf, gd, p, 4, K.GAMMA2_POW)):
                try:
                    launch()
                except RuntimeError:
                    continue
                raise AssertionError(f"cls losses {name!r}: the 16-byte instance launched")
            if (K.fwd_launches, K.bwd_launches) != before:
                raise AssertionError(f"cls losses {name!r}: a refused launch was counted")
        fwd_err = max(fwd_err, float((sums - ref).abs().max()))
        bwd_err = max(bwd_err, float((dx - dref).abs().max()))
        if name in level_of:  # a flagship level: its bounds; P3 timed here
            level = level_of[name]
            b_fwd, b_bwd = _cls_bounds(rows, x.shape[1], g)
            levels.append({"level": level, "rows": rows, "fwd_bound_ms": b_fwd["bound_ms"],
                           "bwd_bound_ms": b_bwd["bound_ms"]})
            if level == 3:  # each call after an L2 flush
                flush = _l2_flush(torch)
                ms_fwd = _median_ms(torch, lambda: K.cls_losses_fwd(x, pt, labels, g, p),
                                    iters * 5, warmup, flush)
                ms_bwd = _median_ms(torch, lambda: K.cls_losses_bwd(x, pt, labels, gf, gd, p),
                                    iters * 5, warmup, flush)
                plain_fwd = _median_ms(torch, lambda: cls_losses_fwd_plain(x, pt, labels, g, p),
                                       iters, warmup, flush)
                plain_bwd = _median_ms(
                    torch, lambda: cls_losses_bwd_plain(x, pt, labels, gf, gd, p), iters, warmup,
                    flush)
                del flush
                p3 = (rows, ms_fwd, ms_bwd, plain_fwd, plain_bwd, b_fwd, b_bwd)
        del x, pt, labels, sums, ref, dx, dref, again

    rows, ms_fwd, ms_bwd, plain_fwd, plain_bwd, b_fwd, b_bwd = p3
    worst = max(rels, key=lambda k: rels[k][0])
    near0 = rels.get("pt log-uniform in 1e-6..1e-3")
    near0 = "" if near0 is None else f"; pt near 0: sums {near0[0]:.2e}, dx {near0[1]:.2e}"
    _phase(phase, f"{len(cases)} cases, sums within 1e-5 relative and dx within "
           f"1e-5 * max|dx| of the plain twin (worst sums {rels[worst][0]:.2e} at {worst!r}, "
           f"dx {max(v[1] for v in rels.values()):.2e}{near0}), two runs bit-equal; "
           f"P3 bs{batch} ({rows} rows x "
           f"80, G={groups}): fwd kernel {ms_fwd:.4f} ms (before the redesign "
           f"{CLS_EARLIER_MS['fwd']}; plain {plain_fwd:.4f}, bound {b_fwd['bound_ms']:.4f}), "
           f"bwd kernel {ms_bwd:.4f} ms (before {CLS_EARLIER_MS['bwd']}; plain "
           f"{plain_bwd:.4f}, bound {b_bwd['bound_ms']:.4f}) (CUDA-event medians of "
           f"{iters * 5}, each call after an L2 flush)", time.perf_counter() - t0)
    per_level = lambda k: [{"level": v["level"], "rows": v["rows"],  # noqa: E731
                            "bound_ms": v[f"{k}_bound_ms"]} for v in levels]
    return ({"max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": plain_fwd, **b_fwd,
             "levels": per_level("fwd")},
            {"max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": plain_bwd, **b_bwd,
             "levels": per_level("bwd")})


def phase_cls_levels(torch, seed, batch, groups, iters, warmup, stats, level_hw=LEVEL_HW,
                     name="cls_loss_levels"):
    """The cls-loss kernels' device time at every level of ``level_hw`` from
    torch.profiler, each call after an L2 flush (_l2_flush), into stats'
    "levels" as "device_ms" (the level's only time: an event median there is
    mostly host time). Run after the main paths: with the profiler run before
    them, the host-bound training steps of the same process read slower
    (PERF.md section 6)."""
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.tools.profile_infer import device_ms

    t0 = time.perf_counter()
    flag = K.ClsLossParams(2.0, 0.25, 2.0, 0.5, 0.0, -1, 1.8, True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = _l2_flush(torch)  # its fill kernel is no "cls_losses" kernel, so not counted
    said = []
    for i, (level, (h, w)) in enumerate(level_hw.items()):
        x, pt, labels, gf, gd = _cls_case(torch, gen, batch * h * w * 9, groups)
        by_kernel = device_ms(lambda: (flush(), K.cls_losses_fwd(x, pt, labels, groups, flag)),
                              iters * 5, warmup, "cls_losses")
        fwd = sum(by_kernel.values())
        sum_kernel = sum(v for k, v in by_kernel.items() if "cls_losses_sum" in k)
        bwd = sum(device_ms(lambda: (flush(), K.cls_losses_bwd(x, pt, labels, gf, gd, flag)),
                            iters * 5, warmup, "cls_losses_bwd").values())
        stats[0]["levels"][i]["device_ms"] = fwd
        stats[1]["levels"][i]["device_ms"] = bwd
        said.append(f"P{level}: fwd {fwd:.4f} (of which the sum kernel {sum_kernel:.4f}; bound "
                    f"{stats[0]['levels'][i]['bound_ms']:.4f}), bwd {bwd:.4f} (bound "
                    f"{stats[1]['levels'][i]['bound_ms']:.4f})")
        del x, pt, labels, gf, gd
    _phase(name, "device ms a call (torch.profiler, mean of "
           f"{iters * 5}, each call after an L2 flush): " + "; ".join(said),
           time.perf_counter() - t0)


def _level_grads(torch, step, s_data, probs, batch):
    """Loss and the gradients of the total loss w.r.t. the 5 levels' cls
    logits, which isolates the loss kernels from cuDNN's backward."""
    out = step.forward(s_data)
    total, metrics = step.losses(out, probs, batch)
    logits = list(out["cls_logits"].values())
    return {k: v.detach() for k, v in metrics.items()}, torch.autograd.grad(total, logits)


def _kernel_ms_by_category(torch, fn, n, category):
    """Kernel ms a call of fn by category (``category(kernel name)``) and in
    all, from torch.profiler over n calls."""
    from sad_tpu_torch.tools.profile_infer import device_ms

    by_cat = {}
    for kernel, ms in device_ms(fn, n, 0).items():
        by_cat[category(kernel)] = by_cat.get(category(kernel), 0.0) + ms
    return by_cat, sum(by_cat.values())


def _cats(by_cat):
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1]))


def phase_joint_step(torch, seed, groups, iters, warmup, name="joint_step", student=STUDENT_CFG,
                     teacher=TEACHER_CFG, level_hw=LEVEL_HW, profile=False):
    """The joint SAD step of a student / teacher pair at full width: a kernel
    step against a plain-twin step, then the main path's steps; with
    ``profile`` also kernel ms a step by category (torch.profiler)."""
    from sad_tpu_torch.ops import cls_loss_kernel
    from sad_tpu_torch.ops.fused_losses import fused_cls_losses_raw_plain
    from sad_tpu_torch.tools.profile_train import BENCH_LR, _category, seeded_train_step
    from sad_tpu_torch.train import make_train_step
    from sad_tpu_torch.tools.profile_infer import wall_seconds

    t0 = time.perf_counter()
    run = seeded_train_step(os.path.join(REPO, student), os.path.join(REPO, teacher), seed=seed,
                            n_groups=groups, device="cuda")
    canvas = (level_hw[3][0] * 8, level_hw[3][1] * 8)
    if tuple(run.batch["data_u8"].shape) != (run.n_images, *canvas, 3):
        raise AssertionError(f"{name} canvas {tuple(run.batch['data_u8'].shape)}, want "
                             f"{canvas}")
    step = run.step
    plain = make_train_step(run.student_cfg, run.student, run.teacher, n_groups=groups,
                            teacher_cfg=run.teacher_cfg, cls_losses=fused_cls_losses_raw_plain)

    # kernels vs plain twin from the same state: a whole step each, then the
    # gradients w.r.t. the cls logits of one forward each
    params = dict(run.student.named_parameters())
    snap = {n: p.detach().clone() for n, p in params.items()}
    vsnap = {n: v.clone() for n, v in run.state.velocity.items()}

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(snap[n])
            for n, v in run.state.velocity.items():
                v.copy_(vsnap[n])

    m_kernel = step(run.state, run.batch, BENCH_LR)
    restore()
    m_plain = plain(run.state, run.batch, BENCH_LR)
    restore()
    worst = max(float((m_kernel[k] - m_plain[k]).abs() / m_plain[k].abs().clamp_min(1e-30))
                for k in m_plain)
    if sorted(m_kernel) != sorted(m_plain) or not worst <= 1e-5:
        raise AssertionError(f"joint step metrics, kernels vs plain twin: worst rel err {worst:.3e}")
    s_data, t_data = step.inputs(run.batch)
    probs = step.teacher_probs(t_data)
    _, g_kernel = _level_grads(torch, step, s_data, probs, run.batch)
    _, g_plain = _level_grads(torch, plain, s_data, probs, run.batch)
    gworst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_kernel, g_plain))
    if not gworst <= 1e-5:
        raise AssertionError(f"cls-logit gradients, kernels vs plain twin: {gworst:.3e} of max")
    del s_data, t_data, probs, g_kernel, g_plain

    # the main path: warm-up and timed steps
    t_mask = step.names
    frozen = {n: snap[n] for n in params if n not in set(t_mask)}
    teacher_snap = [p.detach().clone() for p in run.teacher.parameters()]
    losses = []
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, run.batch, BENCH_LR)["loss"]),
                         iters, warmup)
    torch.cuda.synchronize()
    launches = (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)
    by_rows = (cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows)
    n_steps = iters + warmup
    if launches != (5 * n_steps, 5 * n_steps):
        raise AssertionError(f"cls-loss kernels launched {launches} times in {n_steps} "
                             f"steps, want 5 + 5 a step")
    # each level's (rows, 80) grid: one launch of each kernel a step
    level_rows = {lvl: run.n_images * h * w * 9 for lvl, (h, w) in level_hw.items()}
    per_level = {lvl: (by_rows[0].get(r, 0), by_rows[1].get(r, 0)) for lvl, r in level_rows.items()}
    if any(v != (n_steps, n_steps) for v in per_level.values()):
        raise AssertionError(f"cls-loss launches by level (fwd, bwd) {per_level} in {n_steps} "
                             f"steps, want one of each a level a step")
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"non-finite joint-step loss: {vals}")
    # every trainable tensor got a gradient (its momentum is not zero), and
    # the weights moved; at LR 1e-6 an update below half an ulp of its weight
    # rounds away in float32 (e.g. the cls bias at -4.6), so a few may not
    still = [n for n in t_mask if not bool(run.state.velocity[n].any())]
    if still:
        raise AssertionError(f"{len(still)} trainable tensors got no update, e.g. {still[:3]}")
    unchanged = [n for n in t_mask if torch.equal(params[n], snap[n])]
    if len(unchanged) > len(t_mask) // 10:
        raise AssertionError(f"{len(unchanged)} of {len(t_mask)} trainable tensors did not "
                             f"change, e.g. {unchanged[:3]}")
    moved = [n for n in frozen if not torch.equal(params[n], frozen[n])]
    if moved:
        raise AssertionError(f"frozen student tensors changed: {moved[:3]}")
    if not all(torch.equal(p, q) for p, q in zip(run.teacher.parameters(), teacher_snap)):
        raise AssertionError("the teacher's parameters changed")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cats = ""
    if profile:  # after the counts were read: these steps are no part of the main path
        by_cat, busy = _kernel_ms_by_category(
            torch, lambda: step(run.state, run.batch, BENCH_LR), 3, _category)
        cats = (f"; kernel ms a step {busy:.3f} (torch.profiler, 3 steps): {_cats(by_cat)}; "
                f"device idle {1 - busy / (1000 * med):.4f} of the median step")
    pair = f"{os.path.basename(student)} + {os.path.basename(teacher)}"
    _phase(name, f"{pair}, {run.n_images}x{canvas[0]}x{canvas[1]} uint8, "
           f"G={groups}, bf16, LR {BENCH_LR}: metrics of a kernel step and a plain-twin step "
           f"within {worst:.2e} rel, cls-logit grads within {gworst:.2e} of max; {n_steps} "
           f"steps, loss {vals[0]:.4f} -> {vals[-1]:.4f}, all {len(t_mask)} trainable tensors "
           f"updated and {len(t_mask) - len(unchanged)} changed (unchanged: {unchanged}), "
           f"{len(frozen)} frozen and the teacher bit-identical, kernels launched "
           f"{launches[0]} fwd + {launches[1]} bwd (fwd, bwd by level: {per_level}); "
           f"{run.n_images / med:.2f} imgs/s, "
           f"{1000 * med:.3f} ms/step (median of {iters} after {warmup} warm-up), peak "
           f"{peak:.2f} GiB{cats}", time.perf_counter() - t0)
    return launches, per_level


def phase_infer(torch, name, cfg_path, seed, batch, iters, warmup, canvas=(640, 1024),
                profile=False):
    """A RetinaNet config's serving path at full width on ``canvas``; with
    ``profile`` also kernel ms a batch by category (torch.profiler). Returns
    imgs/s and the NMS launches of the main path's batches (the check's, the
    warm-up's and the timed ones; not the profiled ones)."""
    from sad_tpu_torch.eval.inference import decode_candidates, device_normalize, gather_detections
    from sad_tpu_torch.ops import nms_kernel
    from sad_tpu_torch.ops.nms import nms_multi_plain, offset_by_class
    from sad_tpu_torch.tools.profile_infer import _category, seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, cfg_path), seed, batch, "cuda")
    if tuple(args[0].shape) != (batch, *canvas, 3):
        raise AssertionError(f"{name}: canvas {tuple(args[0].shape)}, want {batch}x{canvas}x3")
    data, im_hw, im_scale, content_hw = args
    before = nms_kernel.launches
    dets = infer(*args)
    torch.cuda.synchronize()
    max_out = cfg.TEST.DETECTIONS_PER_IM
    n_fg = cfg.MODEL.NUM_CLASSES - 1
    for key in ("boxes", "scores", "classes", "valid"):
        want = (batch, max_out, 4) if key == "boxes" else (batch, max_out)
        if tuple(dets[key].shape) != want:
            raise AssertionError(f"{name}: {key} shape {tuple(dets[key].shape)} != {want}")
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"]).all()):
        raise AssertionError(f"{name}: non-finite boxes")
    cls = dets["classes"][valid]
    if cls.numel() == 0 or int(cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"{name}: {cls.numel()} detections, classes outside 1..{n_fg}")
    if nms_kernel.launches == before:
        raise AssertionError(f"{name}: the NMS kernel was not launched")

    # the same per-level outputs through decode with the plain NMS, on the card
    with torch.inference_mode():
        out = model(device_normalize(cfg, data, content_hw))
        cands = decode_candidates(cfg, out, im_hw, im_scale, cfg.TEST.BBOX_REG)
        ref = gather_detections(cands, *nms_multi_plain(
            *offset_by_class(*cands), cfg.TEST.NMS, max_out))
    for key in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(dets[key], ref[key]):
            raise AssertionError(f"{name}: {key} differs from the plain-NMS decode")

    times = wall_seconds(lambda: infer(*args), iters, warmup)
    med = statistics.median(times)
    launched = nms_kernel.launches - before
    if launched != 1 + warmup + iters:
        raise AssertionError(f"{name}: the NMS kernel launched {launched}x in "
                             f"{1 + warmup + iters} batches")
    cats = ""
    if profile:  # after the count was read: these batches are no part of the main path
        torch.cuda.reset_peak_memory_stats()
        by_cat, busy = _kernel_ms_by_category(torch, lambda: infer(*args), 5, _category)
        cats = (f"; kernel ms a batch {busy:.3f} (torch.profiler, 5 batches): {_cats(by_cat)}; "
                f"device idle {1 - busy / (1000 * med):.4f} of the median batch; peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _phase(name, f"{cfg_path}: {batch}x{canvas[0]}x{canvas[1]} uint8, {int(valid.sum())} "
           f"detections, classes in 1..{n_fg}, finite boxes, equal to the plain-NMS decode, "
           f"NMS kernel launched {launched}x in {1 + warmup + iters} batches; "
           f"{batch / med:.2f} imgs/s, {1000 * med / batch:.3f} ms/img (median of {iters} after {warmup} warm-up){cats}", time.perf_counter() - t0)
    return {"imgs_per_s": batch / med, "nms_launches": launched}


def _edge_rois(torch, rng, batch, canvas, r):
    """rois that exercise the edge rules: wholly outside the map, zero area,
    1:60 and 60:1 aspect ratios, on the last row and column, negative
    extents, and random ones; a fifth of the slots invalid."""
    ch, cw = canvas
    xy = rng.uniform(0, [cw * 0.9, ch * 0.9], (r, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(ch * 0.9), (r, 2)))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [cw - 1, ch - 1])], axis=1)
    special = [
        [-3.0 * cw, -2.0 * ch, -2.5 * cw, -1.5 * ch], [2.0 * cw, 2.0 * ch, 2.5 * cw, 2.2 * ch],
        [10.0, 10.0, 10.0, 10.0], [cw / 2, ch / 2, cw / 2, ch / 2 + 30],
        [5.0, 1.0, 9.0, ch - 2.0], [1.0, 5.0, cw - 2.0, 9.0],
        [cw - 20.0, ch - 12.0, cw - 1.0, ch - 1.0], [cw - 1.0, ch - 1.0, cw - 1.0, ch - 1.0],
        [0.0, 0.0, cw - 1.0, ch - 1.0], [30.0, 40.0, 20.0, 10.0],
        [-8.0, -8.0, 12.0, 12.0], [cw - 6.0, ch - 6.0, cw + 40.0, ch + 40.0],
    ]
    boxes[:len(special)] = special
    rois = np.concatenate([np.sort(rng.randint(0, batch, r))[:, None], boxes], axis=1)
    valid = rng.uniform(size=r) > 0.2
    valid[:len(special)] = True
    return (torch.from_numpy(rois.astype(np.float32)).cuda(), torch.from_numpy(valid).cuda())


def _roi_feats(torch, gen, batch, canvas, c, dtype, lvl_min=2, lvl_max=5):
    return {l: torch.randn((batch, max(canvas[0] >> l, 1), max(canvas[1] >> l, 1), c),
                           generator=gen, device="cuda").to(dtype)
            for l in range(lvl_min, lvl_max + 1)}


def _roi_align_check(torch, name, feats, rois, levels, valid, res, sr):
    """Kernel against plain twin on one case: within the tolerance and, since
    the two add the same products in the same order, bit for bit; returns max
    abs err."""
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain

    got = multilevel_roi_align(feats, rois, levels, valid, res, sr)
    ref = multilevel_roi_align_plain(feats, rois, levels, valid, res, sr)
    torch.cuda.synchronize()
    dtype = feats[min(feats)].dtype
    if got.dtype != dtype or got.shape != ref.shape or not bool(torch.isfinite(ref.float()).all()):
        raise AssertionError(f"roi_align {name!r}: dtype/shape/finite check failed")
    if bool(got[~valid].any()):
        raise AssertionError(f"roi_align {name!r}: an invalid roi is not all zeros")
    g, f = got.float(), ref.float()
    err = (g - f).abs()
    if dtype == torch.float32:
        limit = 1e-5 * float(f.abs().max()) + 1e-6
        bad = int((err > limit).sum())
    else:  # one bf16 ulp: 2^-7 of the larger magnitude
        bad = int((err > 2.0 ** -7 * torch.maximum(g.abs(), f.abs())).sum())
    if bad:
        raise AssertionError(f"roi_align {name!r} ({dtype}): {bad} of {err.numel()} elements "
                             f"beyond the tolerance, max abs err {float(err.max()):.3e}")
    if not torch.equal(got, ref):
        raise AssertionError(f"roi_align {name!r} ({dtype}): {int((got != ref).sum())} of "
                             f"{got.numel()} elements not bit-equal to the plain twin")
    return float(err.max()), float((g == f).float().mean())


def phase_roi_align(torch, seed, batch, iters, warmup, timers):
    """The forward kernel against its plain twin, bit for bit, on the main
    paths' shapes and the edge cases; CUDA-event medians at the two serving
    shapes, whose calls go into ``timers`` for their device time, read after
    the main paths."""
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
    from sad_tpu_torch.ops.roi_align import (
        multilevel_roi_align, multilevel_roi_align_plain, roi_geometry,
    )
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound, rpn_like_rois

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 7)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    n_cases, worst, stats, said = 0, 0.0, {}, []
    before = roi_align_kernel.launches

    # the two shapes of the main path, both dtypes; times at bf16, the path's dtype
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, batch, RCNN_CANVAS, 256, dtype)
        for key, per_im, res in (("box", 1000, 7), ("mask", 100, 14)):
            rois, valid = rpn_like_rois(rng, batch, per_im, RCNN_CANVAS, "cuda")
            levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
            err, same = _roi_align_check(torch, f"{key} shape", feats, rois, levels, valid, res, 2)
            worst, n_cases = max(worst, err), n_cases + 1
            if dtype != torch.bfloat16:
                continue
            run = (lambda f=feats, r=rois, lv=levels, v=valid, rs=res:
                   multilevel_roi_align(f, r, lv, v, rs, 2))
            if key == "box":  # two runs give the same bits
                if not torch.equal(run(), run()):
                    raise AssertionError("roi_align box shape: two runs differ")
                n_cases += 1
            ms = _median_ms(torch, run, iters * 5, warmup)
            plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(
                feats, rois, levels, valid, res, 2), iters, warmup)
            b, nbytes, touched = roi_align_bound(feats, rois, levels, valid, res, 2)
            counts = torch.bincount(levels[valid], minlength=6)[2:].tolist()
            if min(counts) == 0:
                raise AssertionError(f"roi_align {key} shape: a level got no roi: {counts}")
            stats[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
            timers[key] = (run, stats[key])
            said.append(f"{key} shape R={rois.shape[0]} res={res} bf16, rois per level P2..P5 "
                        f"{counts}: kernel {ms:.4f} ms (event median), plain {plain_ms:.4f} ms, "
                        f"{nbytes / 1e6:.1f} MB ({touched} cells touched), bound "
                        f"{b['bound_ms']:.4f} ms by {b['bound_by']}, max abs err {err:.3e}, "
                        f"{100 * same:.3f} % of elements bit-equal")
        del feats

    # edge rules, odd sizes and the scalar instances, both dtypes
    small = (256, 384)
    edge = [  # name, batch, canvas, C, R, res, sr, levels
        ("edge rois, C=64, R=37", 2, small, 64, 37, 7, 2, (2, 5)),
        ("edge rois, res 14", 2, small, 64, 53, 14, 2, (2, 5)),
        ("C=3: the scalar instance, one lane", 3, small, 3, 29, 7, 2, (2, 5)),
        ("C=20: the scalar instance", 1, small, 20, 31, 7, 2, (2, 5)),
        ("1x2 top level", 1, (32, 64), 256, 16, 7, 2, (2, 5)),
        ("one level only", 2, small, 64, 23, 7, 2, (3, 3)),
        ("sr=1", 2, small, 64, 37, 7, 1, (2, 5)),
        ("sr=3", 2, small, 64, 37, 7, 3, (2, 5)),
    ]
    for name, b, canvas, c, r, res, sr, (lo, hi) in edge:
        rois, valid = _edge_rois(torch, rng, b, canvas, r)
        levels = map_rois_to_fpn_levels(rois[:, 1:], lo, hi)
        for dtype in (torch.float32, torch.bfloat16):
            feats = _roi_feats(torch, gen, b, canvas, c, dtype, lo, hi)
            if name == "1x2 top level" and tuple(feats[5].shape[1:3]) != (1, 2):
                raise AssertionError(f"top level is {tuple(feats[5].shape)}")
            err, _ = _roi_align_check(torch, name, feats, rois, levels, valid, res, sr)
            worst, n_cases = max(worst, err), n_cases + 1
    # rois wider than the staging buffer: the whole 200x336 P2 map of the
    # 800x1344 canvas (bands of bin rows, and column chunks at res 28) and the
    # whole P3 map, among spread rois
    ch, cw = RCNN_CANVAS
    rois, valid = rpn_like_rois(rng, 2, 30, RCNN_CANVAS, "cuda")
    rois[:3] = torch.tensor([[0, 0, 0, cw - 1, ch - 1], [1, 0, 0, cw - 1, ch - 1],
                             [1, cw / 3, ch / 3, cw - 1, ch - 1]], device="cuda")
    valid[:3] = True
    levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
    levels[:3] = torch.tensor([2, 3, 2], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, 2, RCNN_CANVAS, 256, dtype)
        for res in (7, 14, 28):
            err, _ = _roi_align_check(torch, f"rois wider than the buffer, res {res}", feats, rois,
                                      levels, valid, res, 2)
            worst, n_cases = max(worst, err), n_cases + 1
        del feats
    # 600 rois on one image and one level, a tenth of them on one cell
    rois, _ = rpn_like_rois(rng, 1, 600, RCNN_CANVAS, "cuda")
    rois[:60] = torch.tensor([0.0, 41.0, 61.0, 43.0, 62.5], device="cuda")
    valid = torch.ones(600, dtype=torch.bool, device="cuda")
    levels = torch.full((600,), 2, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, 1, RCNN_CANVAS, 64, dtype)
        err, _ = _roi_align_check(torch, "600 rois on one image and level", feats, rois, levels,
                                  valid, 7, 2)
        worst, n_cases = max(worst, err), n_cases + 1
    # C = 1 at res 28 over {0, 1} rasters of 200x336 (the mask-target crop's shape)
    rois, valid = rpn_like_rois(rng, 40, 8, RCNN_CANVAS, "cuda")
    levels = torch.full((rois.shape[0],), 2, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        maps = {2: (torch.rand((40, ch // 4, cw // 4, 1), generator=gen, device="cuda") > 0.5)
                .to(dtype)}
        err, _ = _roi_align_check(torch, "C=1 at res 28", maps, rois, levels, valid, 28, 2)
        worst, n_cases = max(worst, err), n_cases + 1
    # rois past 2^19 cells on a map over 2^20 cells wide, where float rounding
    # steps some roi's sample position back a cell: two slots a tap on that axis
    w, r = 2**20 + 64, 256
    x1 = rng.uniform(2**21, 2**22, r)
    rois = torch.from_numpy(np.stack([np.zeros(r), x1, np.zeros(r), x1 + rng.uniform(0, 12, r),
                                      np.full(r, 6.0)], axis=1).astype(np.float32)).cuda()
    levels = torch.full((r,), 2, dtype=torch.int32, device="cuda")
    valid = torch.ones(r, dtype=torch.bool, device="cuda")
    xlo = roi_geometry([(2, w)], 2, 1, rois, levels, 28, 2)[5][0].reshape(r, -1)
    if not bool((xlo[:, 1:] < xlo[:, :-1]).any()):
        raise AssertionError("roi_align: no roi's x positions fail to grow on the wide map")
    for c in (1, 64):
        for dtype in (torch.float32, torch.bfloat16):
            maps = {2: torch.randn((1, 2, w, c), generator=gen, device="cuda").to(dtype)}
            err, _ = _roi_align_check(torch, f"positions that fail to grow, C={c}", maps, rois,
                                      levels, valid, 28, 2)
            worst, n_cases = max(worst, err), n_cases + 1
    # all rois invalid: zeros, and the kernel still counts as launched
    feats = _roi_feats(torch, gen, 1, small, 64, torch.bfloat16)
    rois, valid = _edge_rois(torch, rng, 1, small, 19)
    out = multilevel_roi_align(feats, rois, map_rois_to_fpn_levels(rois[:, 1:], 2, 5),
                               torch.zeros_like(valid), 7, 2)
    if bool(out.any()):
        raise AssertionError("roi_align: all-invalid rois gave non-zero output")
    n_cases += 1
    launched = roi_align_kernel.launches - before
    _phase("roi_align_kernel", f"{n_cases} cases bit-equal to the plain twin (and within its "
           f"tolerance: float32 1e-5 * max|ref| + 1e-6; bfloat16 one ulp), two runs bit-equal, "
           f"worst abs err {worst:.3e}, {launched} launches; medians: " + "; ".join(said),
           time.perf_counter() - t0)
    return stats


def phase_roi_align_device(torch, timers, iters, warmup):
    """The RoIAlign forward's device time at each main-path shape, into its
    stats as "device_ms": the mean of iters * 5 calls queued behind a spin
    kernel, each between two CUDA events (``queued_ms``; torch.profiler lost
    half of these launches late in the script, PERF.md section 6). The
    phase's line prints the earlier kernel's (ROI_FWD_EARLIER_MS, other rois
    of the same shape, torch.profiler) beside it. Run after the main paths,
    as [cls_loss_levels] is."""
    from sad_tpu_torch.tools.profile_infer import queued_ms

    t0 = time.perf_counter()
    said = []
    for key, (run, stats) in timers.items():
        ms = queued_ms(run, iters * 5, warmup)
        stats["device_ms"] = ms
        earlier = ROI_FWD_EARLIER_MS.get(key)
        said.append(f"{key} {ms:.4f}"
                    + (f" (earlier kernel on profile_roi_align.py's rois: {earlier})"
                       if earlier else "")
                    + (f", bound {stats['bound_ms']:.4f}" if "bound_ms" in stats else ""))
    _phase("roi_align_device", "device ms a call (CUDA events around each of "
           f"{iters * 5} calls queued behind a spin kernel, mean): " + "; ".join(said),
           time.perf_counter() - t0)


def _roi_align_bwd_bound(feats_hw, batch, c, esize, r, res, sr):
    """RoIAlign backward: the cotangent read once, every gradient map written
    once (it is dense: cells no roi touched are zeros that must be written),
    the rois, levels and valid flags read once; a multiply and an add per tap."""
    cells = batch * sum(h * w for h, w in feats_hw)
    elems = r * res * res * c
    bytes_moved = elems * esize + cells * c * esize + r * (20 + 4 + 1)
    return bound(bytes_moved, 2 * 4 * sr * sr * elems), bytes_moved


def _roi_align_bwd_check(torch, name, feats, rois, levels, valid, res, sr, gen, positive=False,
                         rel=1e-5):
    """Backward kernel against its plain version on one case, through the
    wrapper and through autograd; returns max abs err. ``positive`` (a
    cotangent without signs, so that nothing cancels) and a wider ``rel`` are
    for a cell that collects ~10^4 terms: both versions add them in float32
    in an order of their own, and the rounding of such a sum is ~1e-5 of it."""
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_bwd_plain

    lvls = sorted(feats)
    f0 = feats[lvls[0]]
    b, c, dtype = f0.shape[0], f0.shape[-1], f0.dtype
    hw = {l: tuple(feats[l].shape[1:3]) for l in lvls}
    g = torch.randn((rois.shape[0], res, res, c), generator=gen, device="cuda")
    g = (g.abs() if positive else g).to(dtype)
    got = roi_align_kernel.roi_align_bwd_cuda(g, [hw[l] for l in lvls], lvls[0], b, rois,
                                              levels, valid, sr)
    ref = multilevel_roi_align_bwd_plain(g, hw, b, rois, levels, valid, sr)
    leaves = {l: f.detach().requires_grad_(True) for l, f in feats.items()}
    out = multilevel_roi_align(leaves, rois, levels, valid, res, sr)
    # a cotangent that is a non-contiguous view, as autograd may hand over
    auto = torch.autograd.grad(out, [leaves[l] for l in lvls],
                               g.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    ref_max = max(float(ref[l].float().abs().max()) for l in lvls)
    worst = 0.0
    for k, l in enumerate(lvls):
        for what, t in (("wrapper", got[k]), ("autograd", auto[k])):
            if t.dtype != dtype or t.shape != feats[l].shape:
                raise AssertionError(f"roi_align_bwd {name!r}: {what} P{l} is {t.dtype} "
                                     f"{tuple(t.shape)}")
            a, f = t.float(), ref[l].float()
            err = (a - f).abs()
            limit = rel * ref_max + 1e-30
            if dtype != torch.float32:  # one bf16 ulp after the single cast
                limit = limit + 2.0 ** -7 * torch.maximum(a.abs(), f.abs())
            bad = int((err > limit).sum())
            if bad or not bool(torch.isfinite(a).all()):
                raise AssertionError(
                    f"roi_align_bwd {name!r} ({dtype}, {what}, P{l}): {bad} of {err.numel()} "
                    f"elements beyond the tolerance, max abs err {float(err.max()):.3e}, "
                    f"max|ref| {ref_max:.3e}")
            worst = max(worst, float(err.max()))
    return worst


def phase_roi_align_bwd(torch, seed, batch, iters, warmup, timers):
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
    from sad_tpu_torch.ops.roi_align import (
        multilevel_roi_align, multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
    )
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound, rpn_like_rois

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 11)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    n_cases, worst, stats, said = 0, 0.0, {}, []
    before = roi_align_kernel.bwd_launches

    # the two shapes of the training step, both dtypes; times at bf16, the step's dtype
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, batch, RCNN_CANVAS, 256, dtype)
        hw = {l: tuple(f.shape[1:3]) for l, f in feats.items()}
        for key, per_im, res in (("box", 512, 7), ("mask", 128, 14)):
            rois, valid = rpn_like_rois(rng, batch, per_im, RCNN_CANVAS, "cuda")
            levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
            err = _roi_align_bwd_check(torch, f"{key} shape", feats, rois, levels, valid, res, 2,
                                       gen)
            worst, n_cases = max(worst, err), n_cases + 1
            ferr, _ = _roi_align_check(torch, f"{key} shape of the step", feats, rois, levels,
                                       valid, res, 2)
            if dtype != torch.bfloat16:
                continue
            run = (lambda f=feats, r=rois, lv=levels, v=valid, rs=res:
                   multilevel_roi_align(f, r, lv, v, rs, 2))
            fms = _median_ms(torch, run, iters * 3, warmup)
            fplain = _median_ms(torch, lambda: multilevel_roi_align_plain(
                feats, rois, levels, valid, res, 2), max(iters // 2, 2), 1)
            fb, _, _ = roi_align_bound(feats, rois, levels, valid, res, 2)
            stats[f"fwd_{key}"] = {"max_abs_err": ferr, "ms": fms, "plain_ms": fplain, **fb}
            timers[f"{key}_train"] = (run, stats[f"fwd_{key}"])
            said.append(f"forward at the {key} shape of the step: kernel {fms:.4f} ms (event "
                        f"median), plain {fplain:.4f} ms, bound {fb['bound_ms']:.4f} ms")
            g = torch.randn((rois.shape[0], res, res, 256), generator=gen,
                            device="cuda").to(dtype)
            dims = [hw[l] for l in sorted(hw)]
            once = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, batch, rois, levels, valid, 2)
            again = roi_align_kernel.roi_align_bwd_cuda(g, dims, 2, batch, rois, levels, valid, 2)
            if not all(torch.equal(a, b) for a, b in zip(once, again)):
                raise AssertionError(f"roi_align_bwd {key} shape: two runs differ")
            del once, again
            ms = _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
                g, dims, 2, batch, rois, levels, valid, 2), iters * 3, warmup)
            plain_ms = _median_ms(torch, lambda: multilevel_roi_align_bwd_plain(
                g, hw, batch, rois, levels, valid, 2), max(iters // 2, 2), 1)
            b, nbytes = _roi_align_bwd_bound(dims, batch, 256, g.element_size(), rois.shape[0],
                                             res, 2)
            stats[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
            said.append(f"{key} shape R={rois.shape[0]} res={res} bf16, spread rois: kernel "
                        f"{ms:.4f} ms (the atomic scatter of PERF.md row #8: "
                        f"{ROI_BWD_EARLIER_MS[key]} ms), plain {plain_ms:.4f} ms, "
                        f"{nbytes / 1e6:.1f} MB, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
                        f"max abs err {err:.3e}, two runs bit-equal")
            del g
        del feats

    small = (256, 384)
    edge = [  # name, batch, canvas, C, R, res, sr, levels
        ("edge rois, C=64, R=37", 2, small, 64, 37, 7, 2, (2, 5)),
        ("edge rois, res 14", 2, small, 64, 53, 14, 2, (2, 5)),
        ("C=3: no vector loads", 3, small, 3, 29, 7, 2, (2, 5)),
        ("C=20 float32 vectors, bf16 scalars", 1, small, 20, 31, 7, 2, (2, 5)),
        ("1x2 top level", 1, (32, 64), 256, 16, 7, 2, (2, 5)),
        ("one level only", 2, small, 64, 23, 7, 2, (3, 3)),
        ("sr=1", 2, small, 64, 37, 7, 1, (2, 5)),
        ("sr=3", 2, small, 64, 37, 7, 3, (2, 5)),
    ]
    for name, b, canvas, c, r, res, sr, (lo, hi) in edge:
        rois, valid = _edge_rois(torch, rng, b, canvas, r)
        levels = map_rois_to_fpn_levels(rois[:, 1:], lo, hi)
        for dtype in (torch.float32, torch.bfloat16):
            feats = _roi_feats(torch, gen, b, canvas, c, dtype, lo, hi)
            err = _roi_align_bwd_check(torch, name, feats, rois, levels, valid, res, sr, gen)
            worst, n_cases = max(worst, err), n_cases + 1
    # rois that span many map tiles: the whole canvas on P5 (4 x 6 tiles) and on P2
    # (25 x 42), a quarter of it on P3, among spread rois, at the training canvas
    rois, valid = rpn_like_rois(rng, 2, 40, RCNN_CANVAS, "cuda")
    ch, cw = RCNN_CANVAS
    big = [[0, 0, 0, cw - 1, ch - 1], [1, 0, 0, cw - 1, ch - 1], [0, 0, 0, cw - 1, ch - 1],
           [1, cw / 4, ch / 4, 3 * cw / 4, 3 * ch / 4]]
    rois[:4] = torch.tensor(big, device="cuda")
    valid[:4] = True
    levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
    levels[:4] = torch.tensor([5, 5, 2, 3], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = _roi_feats(torch, gen, 2, RCNN_CANVAS, 256, dtype)
        for res in (7, 14):
            err = _roi_align_bwd_check(torch, f"rois over many tiles, res {res}", feats, rois,
                                       levels, valid, res, 2, gen)
            worst, n_cases = max(worst, err), n_cases + 1
        del feats
    # 600 rois on one and the same cell of P2: one tile's list holds all of them
    feats = _roi_feats(torch, gen, 2, small, 256, torch.float32)
    rois = torch.tensor([[1.0, 41.0, 61.0, 43.0, 62.5]], device="cuda").repeat(600, 1)
    valid = torch.ones(600, dtype=torch.bool, device="cuda")
    levels = torch.full((600,), 2, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        err = _roi_align_bwd_check(torch, "600 rois on one cell",
                                   {l: f.to(dtype) for l, f in feats.items()}, rois, levels,
                                   valid, 7, 2, gen, positive=True, rel=1e-4)
        worst, n_cases = max(worst, err), n_cases + 1
    # all rois invalid: zeros
    hw = [tuple(feats[l].shape[1:3]) for l in sorted(feats)]
    g = torch.randn((600, 7, 7, 256), generator=gen, device="cuda")
    zero = roi_align_kernel.roi_align_bwd_cuda(g, hw, 2, 2, rois, levels, ~valid, 2)
    if any(bool(z.any()) for z in zero):
        raise AssertionError("roi_align_bwd: all-invalid rois gave a non-zero gradient")
    n_cases += 1
    launched = roi_align_kernel.bwd_launches - before
    _phase("roi_align_bwd_kernel", f"{n_cases} cases, wrapper and autograd, within tolerance of "
           f"the plain version (float32 1e-5 * max|ref|, 1e-4 where 600 rois share a cell; bfloat16 "
           f"one ulp more; the two add in other orders, so not bit-equal), worst abs err "
           f"{worst:.3e}, {launched} launches; medians: " + "; ".join(said),
           time.perf_counter() - t0)
    return stats


@contextlib.contextmanager
def _plain_twins():
    """For a check only: the plain NMS and the plain RoIAlign, forward and
    backward, in place of the three CUDA wrappers, so that the same entry
    points run without a kernel."""
    from sad_tpu_torch.ops import nms, nms_kernel, roi_align, roi_align_kernel

    def plain_roi_align(feats, lvl_min, rois, levels, valid, res, sr):
        return roi_align.multilevel_roi_align_plain(
            {lvl_min + i: f for i, f in enumerate(feats)}, rois, levels, valid, res, sr)

    def plain_roi_align_bwd(grad_out, level_hw, lvl_min, batch, rois, levels, valid, sr):
        out = roi_align.multilevel_roi_align_bwd_plain(
            grad_out, {lvl_min + i: hw for i, hw in enumerate(level_hw)}, batch, rois, levels,
            valid, sr)
        return [out[l] for l in sorted(out)]

    k = roi_align_kernel
    saved = nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda
    nms_kernel.nms_cuda = nms.nms_multi_plain
    k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = plain_roi_align, plain_roi_align_bwd
    try:
        yield
    finally:
        nms_kernel.nms_cuda, k.roi_align_fwd_cuda, k.roi_align_bwd_cuda = saved


def phase_rcnn_infer(torch, name, cfg_path, seed, batch, iters, warmup):
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.tools.profile_infer import seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, cfg_path), seed, batch, "cuda")
    if tuple(args[0].shape) != (batch, *RCNN_CANVAS, 3):
        raise AssertionError(f"{name}: canvas {tuple(args[0].shape)}")
    dets = infer(*args)
    torch.cuda.synchronize()
    max_out, n_fg = cfg.TEST.DETECTIONS_PER_IM, cfg.MODEL.NUM_CLASSES - 1
    keys = ("boxes", "scores", "classes", "valid")
    for key in keys:
        want = (batch, max_out, 4) if key == "boxes" else (batch, max_out)
        if tuple(dets[key].shape) != want:
            raise AssertionError(f"{name}: {key} shape {tuple(dets[key].shape)} != {want}")
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"]).all()) or not bool(torch.isfinite(dets["scores"]).all()):
        raise AssertionError(f"{name}: non-finite boxes or scores")
    cls = dets["classes"][valid]
    per_im = valid.sum(dim=1).tolist()
    if min(per_im) < max_out // 2 or int(cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"{name}: detections per image {per_im} (want >= {max_out // 2} "
                             f"each), classes outside 1..{n_fg}")
    with torch.inference_mode():
        out = model(device_normalize(cfg, args[0], args[3]), args[1])
    if not bool(out["roi_valid"].all()) or tuple(out["rois"].shape) != (
            batch, cfg.TEST.RPN_POST_NMS_TOP_N, 4):
        raise AssertionError(f"{name}: the RPN filled {out['roi_valid'].sum(dim=1).tolist()} of "
                             f"{cfg.TEST.RPN_POST_NMS_TOP_N} slots an image")
    roi_levels = torch.bincount(out["roi_levels"].reshape(-1), minlength=6)[2:].tolist()
    del out
    if cfg.MODEL.MASK_ON:
        keys += ("mask_prob",)
        m = cfg.MRCNN.RESOLUTION
        mp = dets["mask_prob"]
        if tuple(mp.shape) != (batch, max_out, m, m, cfg.MODEL.NUM_CLASSES) or not bool(
                ((mp >= 0) & (mp <= 1)).all()):
            raise AssertionError(f"{name}: mask_prob shape {tuple(mp.shape)} or values outside [0, 1]")
    kps_on = bool(cfg.MODEL.KEYPOINTS_ON)
    if kps_on:
        hm = dets["kps_heatmaps"]
        s_hm = 4 * cfg.KRCNN.ROI_XFORM_RESOLUTION
        if tuple(hm.shape) != (batch, max_out, s_hm, s_hm, cfg.KRCNN.NUM_KEYPOINTS) or not bool(
                torch.isfinite(hm).all()):
            raise AssertionError(f"{name}: kps_heatmaps shape {tuple(hm.shape)} or not finite")

    # the same model and batch with the plain NMS and plain RoIAlign
    counts = nms_kernel.launches, roi_align_kernel.launches
    with _plain_twins():
        ref = infer(*args)
    torch.cuda.synchronize()
    if (nms_kernel.launches, roi_align_kernel.launches) != counts:
        raise AssertionError(f"{name}: the plain-twin run launched a kernel")
    for key in keys:
        if not torch.equal(dets[key], ref[key]):
            diff = (dets[key].float() - ref[key].float()).abs()
            raise AssertionError(f"{name}: {key} differs from the plain-twin run: "
                                 f"{int((diff > 0).sum())} entries, max {float(diff.max()):.3e}")
    hm_err = None
    if kps_on:
        # the heatmaps of the same kept boxes: within one bf16 ulp of the larger
        # magnitude (the RoIAlign forward is bit-equal to its twin, so the head
        # sees the same inputs; the bound holds whatever cuDNN picks)
        a, b = dets["kps_heatmaps"].float(), ref["kps_heatmaps"].float()
        hm_err = float((a - b).abs().max())
        bad = int(((a - b).abs() > 2.0 ** -7 * torch.maximum(a.abs(), b.abs())).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} kps_heatmaps entries beyond one bf16 ulp of "
                                 f"the plain-twin run's (max abs diff {hm_err:.3e})")
    del ref

    # the main path: counts set to 0 just before, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    times = wall_seconds(lambda: infer(*args), iters, warmup)
    launches = nms_kernel.launches, roi_align_kernel.launches
    n_batches = iters + warmup
    want = (2 * n_batches, (2 if cfg.MODEL.MASK_ON or kps_on else 1) * n_batches)
    if launches != want:
        raise AssertionError(f"{name}: {launches} NMS / RoIAlign launches in {n_batches} "
                             f"batches, want {want}")
    med = statistics.median(times)
    extra = _keypoint_serving(torch, cfg, model, args, iters, warmup) if kps_on else {}
    _phase(name, f"{cfg_path}: {batch}x{RCNN_CANVAS[0]}x{RCNN_CANVAS[1]} uint8, bf16; RPN filled "
           f"all {cfg.TEST.RPN_POST_NMS_TOP_N} slots (rois per level P2..P5 {roi_levels}), "
           f"detections per image {per_im}, classes in 1..{n_fg}, finite"
           + (", mask_prob in [0, 1]" if cfg.MODEL.MASK_ON else "")
           + (", kps_heatmaps finite" if kps_on else "")
           + f"; {', '.join(keys)} equal to the plain-twin run"
           + (f", kps_heatmaps within one bf16 ulp of it (max abs diff {hm_err:.3e})"
              if kps_on else "")
           + f"; {launches[0]} NMS and "
           f"{launches[1]} RoIAlign launches in {n_batches} batches; {batch / med:.2f} imgs/s, "
           f"{1000 * med / batch:.3f} ms/img (median of {iters} after {warmup} warm-up)"
           + (f"; {extra['said']}" if kps_on else ""),
           time.perf_counter() - t0)
    return {"imgs_per_s": batch / med, "nms_launches": launches[0],
            "roi_align_launches": launches[1], "mask": bool(cfg.MODEL.MASK_ON), **extra}


def _keypoint_serving(torch, cfg, model, args, iters, warmup):
    """Keypoint R-CNN serving beside the main path (no count is read here):
    the device ms of each stage of a batch (CUDA events, medians), and the
    detection NMS at its own shape, one foreground class (8 x 1000 -> 100),
    on this batch's candidates: the kernel against the plain NMS (idx and
    valid exactly equal), both timed, and the bound of this run's data."""
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.eval.rcnn_inference import decode_rcnn_candidates
    from sad_tpu_torch.ops import nms, nms_kernel
    from sad_tpu_torch.tools.profile_infer import _event_ms, rcnn_stages

    stages = rcnn_stages(cfg, model, args)
    per = {n: [] for n, _ in stages}
    with torch.inference_mode():
        for i in range(iters + warmup):
            _, ms = _event_ms([fn for _, fn in stages])
            if i >= warmup:
                for (n, _), t in zip(stages, ms):
                    per[n].append(t)
        out = model(device_normalize(cfg, args[0], args[3]), args[1])
        cands = decode_rcnn_candidates(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                       out["bbox_pred"], args[1], args[2])
        del out
        boxes, scores = nms.offset_by_class(*cands)
        boxes, scores = boxes.float().contiguous(), scores.float().contiguous()
    thr, max_out = cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM
    ik, vk = nms_kernel.nms_cuda(boxes, scores, thr, max_out)
    ip, vp = nms.nms_multi_plain(boxes, scores, thr, max_out)
    if not torch.equal(ik, ip) or not torch.equal(vk, vp):
        raise AssertionError(f"keypoint decode NMS: kernel != plain on the batch's candidates "
                             f"({int((ik != ip).sum()) + int((vk != vp).sum())} entries)")
    ms = _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, thr, max_out),
                    iters * 5, warmup)
    plain_ms = _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, thr, max_out),
                          iters, 1)
    b = _nms_bound(*scores.shape, max_out, vk)
    n_cand = int((scores > -1e29).sum())
    stage_ms = {n: statistics.median(v) for n, v in per.items() if n != "count"}
    said = (f"stage device ms (CUDA events, median of {iters}): "
            + ", ".join(f"{n} {v:.3f}" for n, v in stage_ms.items())
            + f"; detection NMS N={scores.shape[0]} K={scores.shape[1]} ({n_cand} valid) -> "
            f"{max_out}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} "
            f"ms by {b['bound_by']}, {int(vk.sum())} kept, idx and valid equal to the plain NMS")
    return {"stage_ms": stage_ms, "said": said,
            "nms_decode": {"max_abs_err": float((ik - ip).abs().max()), "ms": ms,
                           "plain_ms": plain_ms, **b}}


def _kernel_counts():
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel

    return nms_kernel.launches, roi_align_kernel.launches, roi_align_kernel.bwd_launches


def _roi_branch_grads(torch, step, run, nchw, sampled):
    """The gradients of the box loss and, for Mask / Keypoint R-CNN, of the
    mask / keypoint loss w.r.t. detached NHWC RoI levels: what each RoIAlign
    backward alone produces (their sum would round a second time in bf16)."""
    leaves = run.model.roi_features(
        {l: f.detach().permute(0, 2, 3, 1).requires_grad_(True) for l, f in nchw.items()})
    wrt = [leaves[l] for l in sorted(leaves)]
    grads = list(torch.autograd.grad(step.box_branch(leaves, sampled)[0], wrt))
    if run.cfg.MODEL.MASK_ON:
        grads += torch.autograd.grad(step.mask_branch(leaves, sampled, run.batch), wrt)
    if run.cfg.MODEL.KEYPOINTS_ON:
        grads += torch.autograd.grad(step.keypoint_branch(leaves, sampled, run.batch), wrt)
    return grads


def phase_rcnn_train(torch, name, cfg_path, seed, groups, iters, warmup, timers):
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.ops.roi_align import (
        multilevel_roi_align, multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
    )
    from sad_tpu_torch.tools.profile_infer import wall_seconds
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound
    from sad_tpu_torch.tools.profile_train import BENCH_LR, seeded_rcnn_train_step

    t0 = time.perf_counter()
    run = seeded_rcnn_train_step(os.path.join(REPO, cfg_path), seed=seed, n_groups=groups,
                                 device="cuda")
    cfg, step, batch = run.cfg, run.step, run.batch
    mask_on, kps_on = bool(cfg.MODEL.MASK_ON), bool(cfg.MODEL.KEYPOINTS_ON)
    n = run.n_images
    if tuple(batch["data_u8"].shape) != (n, *RCNN_CANVAS, 3):
        raise AssertionError(f"{name}: canvas {tuple(batch['data_u8'].shape)}")
    params = dict(run.model.named_parameters())
    snap = {k: p.detach().clone() for k, p in params.items()}

    def restore():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap[k])
            for v in run.state.velocity.values():
                v.zero_()

    # one step with the kernels and one with the plain versions, from the same
    # state and the same sampler uniforms
    fast = not cfg.MODEL.FASTER_RCNN  # Fast R-CNN: no RPN, the batch's proposals
    p_all = (batch["proposal_boxes"].shape[1] if fast else cfg.TRAIN.RPN_POST_NMS_TOP_N) + \
        batch["gt_boxes"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    uniforms = (torch.rand((n, p_all), generator=gen, device="cuda"),
                torch.rand((n, p_all), generator=gen, device="cuda"))
    m_kernel = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    counts = _kernel_counts()
    with _plain_twins():
        m_plain = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    torch.cuda.synchronize()
    if _kernel_counts() != counts:
        raise AssertionError(f"{name}: the plain step launched a kernel")
    worst = max(float((m_kernel[k] - m_plain[k]).abs() / m_plain[k].abs().clamp_min(1e-6))
                for k in m_plain)
    if sorted(m_kernel) != sorted(m_plain) or not worst <= 1e-4:
        raise AssertionError(f"{name}: metrics of the kernel step vs the plain step: worst "
                             f"rel err {worst:.3e} (limit 1e-4)")
    if mask_on != ("loss_mask" in m_kernel) or kps_on != ("loss_kps" in m_kernel):
        raise AssertionError(f"{name}: metrics {sorted(m_kernel)} (MASK_ON {mask_on}, "
                             f"KEYPOINTS_ON {kps_on})")

    # the gradients that the RoIAlign backward hands to the FPN outputs
    with torch.no_grad():
        nchw = step.backbone(step.inputs(batch))
        if not fast:
            logits, deltas = run.model.rpn_outputs(nchw)
    if fast:
        boxes, valid = batch["proposal_boxes"], batch["proposal_valid"]
    else:
        boxes, valid = step.proposals(logits, deltas, batch)
        del logits, deltas
    sampled = step.sample(boxes, valid, batch, uniforms)
    g_kernel = _roi_branch_grads(torch, step, run, nchw, sampled)
    with _plain_twins():
        g_plain = _roi_branch_grads(torch, step, run, nchw, sampled)
    torch.cuda.synchronize()
    ref_max = max(float(g.float().abs().max()) for g in g_plain)
    gworst = 0.0
    for a, b in zip(g_kernel, g_plain):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bad = int((err > 1e-5 * ref_max + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {bad} FPN-output gradient elements beyond one bf16 "
                                 f"ulp + 1e-5 * max of the plain backward's")
        gworst = max(gworst, float(err.max()))
    fg_per_im = sampled["is_fg"].sum(dim=1).tolist()
    valid_per_im = sampled["valid"].sum(dim=1).tolist()
    proposals_per_im = valid.sum(dim=1).tolist()
    if min(fg_per_im) < 1:
        raise AssertionError(f"{name}: fg rois per image {fg_per_im}")
    rois5 = flat_rois(sampled["rois"])
    roi_levels = torch.bincount(step._roi_levels(rois5)[sampled["valid"].reshape(-1)],
                                minlength=6)[2:].tolist()

    # the backward kernel on the rois the step really sampled
    res_box, cap = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, step.mask_cap()
    dims = [tuple(nchw[l].shape[2:]) for l in range(2, 6)]
    c = nchw[2].shape[1]
    dtype = nchw[2].dtype
    own = []
    shapes = [("box", rois5, sampled["valid"].reshape(-1), res_box)]
    if mask_on:
        shapes.append(("mask", flat_rois(sampled["rois"][:, :cap]),
                       sampled["is_fg"][:, :cap].reshape(-1), cfg.MRCNN.ROI_XFORM_RESOLUTION))
    if kps_on:
        # the keypoint branch pools the mask row's shape (res 14) from its own prefix
        kcap = step.kps_cap()
        shapes.append(("mask", flat_rois(sampled["rois"][:, :kcap]),
                       sampled["is_fg"][:, :kcap].reshape(-1), cfg.KRCNN.ROI_XFORM_RESOLUTION))
    own_stats = {}
    for key, r5, ok, res in shapes:
        r5 = r5.contiguous()
        lv = step._roi_levels(r5)
        g = torch.randn((r5.shape[0], res, res, c), generator=gen, device="cuda").to(dtype)
        ms = _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
            g, dims, 2, n, r5, lv, ok, 2), iters * 2, warmup)
        plain_ms = _median_ms(torch, lambda: multilevel_roi_align_bwd_plain(
            g, {l: hw for l, hw in zip(range(2, 6), dims)}, n, r5, lv, ok, 2), iters, 1)
        b_, _ = _roi_align_bwd_bound(dims, n, c, g.element_size(), r5.shape[0], res, 2)
        own_stats.setdefault(key, {"max_abs_err": None, "ms": ms, "plain_ms": plain_ms, **b_})
        own.append(f"{'keypoint' if key == 'mask' and kps_on else key} R={r5.shape[0]} "
                   f"({int(ok.sum())} live) {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                   f"{b_['bound_ms']:.4f} ms by {b_['bound_by']})")
        # the forward on the same rois, timed on the device after the main paths
        own_feats = {l: nchw[l].permute(0, 2, 3, 1).contiguous() for l in range(2, 6)}
        timers[f"{key}_train:{name} own rois"] = (
            lambda f=own_feats, r=r5, lv=lv, v=ok, rs=res: multilevel_roi_align(f, r, lv, v, rs, 2),
            {})
    target_stats = None
    if mask_on:
        # the target crop: the forward kernel over the (B * G, Hm, Wm, 1) rasters
        rast = batch["gt_mask_rasters"]
        bb, gg, hm, wm = rast.shape
        maps = {2: rast.reshape(bb * gg, hm, wm, 1).float().contiguous()}
        which = (torch.arange(bb, device="cuda")[:, None] * gg
                 + sampled["matched_gt"][:, :cap]).reshape(-1, 1).float()
        r5 = torch.cat([which, sampled["rois"][:, :cap].reshape(-1, 4)], dim=1).contiguous()
        lv = torch.full((r5.shape[0],), 2, dtype=torch.int32, device="cuda")
        ok = torch.ones((r5.shape[0],), dtype=torch.bool, device="cuda")
        res = cfg.MRCNN.RESOLUTION
        err, _ = _roi_align_check(torch, "mask target crop", maps, r5, lv, ok, res, 2)
        ms = _median_ms(torch, lambda: multilevel_roi_align(maps, r5, lv, ok, res, 2),
                        iters * 2, warmup)
        plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(maps, r5, lv, ok, res, 2),
                              iters, warmup)
        b_, _, _ = roi_align_bound(maps, r5, lv, ok, res, 2)
        target_stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b_}
        timers["mask_targets"] = (
            lambda m=maps, r=r5, l_=lv, v=ok, rs=res: multilevel_roi_align(m, r, l_, v, rs, 2),
            target_stats)
        own.append(f"mask target crop R={r5.shape[0]} res={res} C=1 over {bb * gg} rasters: "
                   f"kernel {ms:.4f} ms (event median), plain {plain_ms:.4f} ms, bound "
                   f"{b_['bound_ms']:.4f} ms")
    del nchw, g_kernel, g_plain, sampled
    for st in own_stats.values():
        st["max_abs_err"] = gworst  # the FPN-output gradients against the plain backward's
    stage_ms = {}
    if kps_on or fast:
        # each stage's device time, before the main path (these steps launch too)
        from sad_tpu_torch.tools.profile_train import rcnn_stage_ms

        per = [rcnn_stage_ms(run, BENCH_LR) for _ in range(iters)]
        stage_ms = {k: statistics.median(p[k] for p in per) for k in per[0]}

    # the main path: counts set to 0 just before, read just after
    frozen = {k: snap[k] for k in params if k not in set(step.names)}
    losses = []
    nms_kernel.launches = roi_align_kernel.launches = roi_align_kernel.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, batch, BENCH_LR)), iters, warmup)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    n_steps = iters + warmup
    want = ((not fast) * n_steps, (1 + 2 * mask_on + kps_on) * n_steps,
            (1 + mask_on + kps_on) * n_steps)
    if launches != want:
        raise AssertionError(f"{name}: NMS / RoIAlign forward / backward launches {launches} in "
                             f"{n_steps} steps, want {want}")
    vals = {k: [float(m[k]) for m in losses] for k in losses[0]}
    if not all(np.isfinite(v).all() for v in vals.values()):
        raise AssertionError(f"{name}: non-finite metrics {vals}")
    still = [k for k in step.names if not bool(run.state.velocity[k].any())]
    # Fast R-CNN: no loss reaches the RPN head, and its biases take no weight decay
    idle = [k for k, bias in zip(step.names, step.is_bias) if fast and bias and
            k.startswith("rpn.")]
    if still != idle:
        raise AssertionError(f"{name}: {len(still)} trainable tensors got no update, e.g. "
                             f"{still[:3]} (want {idle})")
    unchanged = [k for k in step.names if torch.equal(params[k], snap[k])]
    if len(unchanged) > len(step.names) // 10:
        raise AssertionError(f"{name}: {len(unchanged)} of {len(step.names)} trainable tensors "
                             f"did not change, e.g. {unchanged[:3]}")
    moved = [k for k in frozen if not torch.equal(params[k], frozen[k])]
    if moved:
        raise AssertionError(f"{name}: frozen tensors changed: {moved[:3]}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _phase(name, f"{cfg_path}: {n}x{RCNN_CANVAS[0]}x{RCNN_CANVAS[1]} uint8, G={groups}, bf16, LR "
           f"{BENCH_LR}" + (f", {batch['proposal_boxes'].shape[1]} seeded proposals an image "
                            "(no RPN)" if fast else "")
           + f"; kernel step vs plain step from one state: metrics within {worst:.2e} "
           f"rel, FPN-output grads within tolerance (max abs diff {gworst:.3e} of max "
           f"{ref_max:.3e}); proposals per image {proposals_per_im}, sampled valid "
           f"{valid_per_im}, fg {fg_per_im}, rois per level P2..P5 {roi_levels}; backward "
           f"kernel on the step's own rois: " + "; ".join(own) + f"; {n_steps} steps, loss "
           f"{vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f}"
           + (f", loss_mask {vals['loss_mask'][-1]:.4f}" if mask_on else "")
           + (f", loss_kps {vals['loss_kps'][0]:.4f} -> {vals['loss_kps'][-1]:.4f}"
              if kps_on else "")
           + f", all {len(step.names) - len(idle)} trainable tensors updated"
           + (f" (not the RPN head's {len(idle)} biases: no loss, no decay)" if fast else "")
           + " and "
           f"{len(step.names) - len(unchanged)} changed, {len(frozen)} frozen bit-identical; "
           f"launches NMS {launches[0]}, RoIAlign forward {launches[1]}"
           + (" (box, mask and the target crop)" if mask_on else "")
           + (" (box and keypoint)" if kps_on else "")
           + f", backward {launches[2]}; {n / med:.2f} imgs/s, {1000 * med:.3f} ms/step "
           f"(median of {iters} after {warmup} warm-up), peak {peak:.2f} GiB"
           + ("; stage device ms (CUDA events, median of "
              f"{iters}): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
              if stage_ms else ""),
           time.perf_counter() - t0)
    return {"imgs_per_s": n / med, "launches": launches, "steps": n_steps,
            "target_stats": target_stats, "stage_ms": stage_ms, "own_stats": own_stats}


# the single-scale family (C4, VGG, R-FCN): configs, and the reference's 8 GPUs x 1 image
C4_FASTER_CFG = "sad_tpu_torch/configs/e2e_faster_rcnn_R-50-C4.yaml"
C4_MASK_CFG = "sad_tpu_torch/configs/e2e_mask_rcnn_R-50-C4.yaml"
VGG16_CFG = "sad_tpu_torch/configs/faster_rcnn_VGG16.yaml"
RFCN_CFG = "sad_tpu_torch/configs/rfcn_R-101-C4_ohem.yaml"
V0UP_OPTS = ["MRCNN.ROI_MASK_HEAD", "mask_rcnn_heads.mask_rcnn_fcn_head_v0up"]
SS_GROUPS = 8  # groups of TRAIN.IMS_PER_BATCH = 1 image
SS_CANVAS = {C4_FASTER_CFG: RCNN_CANVAS, C4_MASK_CFG: RCNN_CANVAS, VGG16_CFG: (608, 1024),
             RFCN_CFG: (608, 1024)}


def _idle_share(torch, fn, n=3):
    """(device idle share, kernel ms a call) over n profiled calls of fn:
    1 - torch.profiler kernel time / the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return 1.0 - busy / wall_ms, busy / n


def _one_level_case(torch, name, feats, rois5, res, iters, warmup, sr=2):
    """The RoIAlign forward on one level (the single-scale trunk's map) for
    every roi: kernel bit-equal to the plain twin, both timed (CUDA events),
    the bound of this data. Not timed again in roi_align_device, which runs
    before the single-scale phases."""
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound

    (lvl, feat), = feats.items()
    r5 = rois5.float().contiguous()
    lv = torch.full((r5.shape[0],), lvl, dtype=torch.int32, device="cuda")
    ok = torch.ones((r5.shape[0],), dtype=torch.bool, device="cuda")
    feats = {lvl: feat.contiguous()}
    err, _ = _roi_align_check(torch, name, feats, r5, lv, ok, res, sr)
    ms = _median_ms(torch, lambda: multilevel_roi_align(feats, r5, lv, ok, res, sr),
                    iters * 2, warmup)
    plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(feats, r5, lv, ok, res, sr),
                          max(iters // 5, 1), 1)
    b_, _, _ = roi_align_bound(feats, r5, lv, ok, res, sr)
    stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b_}
    said = (f"RoIAlign {name} R={r5.shape[0]} res {res} C={feat.shape[-1]} {feat.dtype} on "
            f"{tuple(feat.shape[1:3])}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_['bound_ms']:.4f} ms by {b_['bound_by']}")
    return stats, said


def phase_ss_infer(torch, name, cfg_path, seed, batch, iters, warmup):
    """A single-scale R-CNN's serving path (C4, VGG16, R-FCN) at full width
    on its canvas: shapes and values, detections (and masks) equal to the
    plain-twin run, the RPN and decode NMS at their own shapes against the
    plain NMS, the box (and cascaded mask) RoIAlign on the batch's own rois
    bit-equal to the plain twin, launches, imgs/s, stage ms and idle."""
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.eval.rcnn_inference import decode_rcnn_candidates, kept_box_rois
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import nms, nms_kernel, roi_align_kernel
    from sad_tpu_torch.ops.proposals import nms_levels_batched, stack_level_problems
    from sad_tpu_torch.tools.profile_infer import _event_ms, rcnn_stages, seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, cfg_path), seed, batch, "cuda")
    canvas = SS_CANVAS[cfg_path]
    if tuple(args[0].shape) != (batch, *canvas, 3):
        raise AssertionError(f"{name}: canvas {tuple(args[0].shape)}")
    dets = infer(*args)
    torch.cuda.synchronize()
    max_out, n_fg = cfg.TEST.DETECTIONS_PER_IM, cfg.MODEL.NUM_CLASSES - 1
    keys = ("boxes", "scores", "classes", "valid")
    for key in keys:
        want = (batch, max_out, 4) if key == "boxes" else (batch, max_out)
        if tuple(dets[key].shape) != want:
            raise AssertionError(f"{name}: {key} shape {tuple(dets[key].shape)} != {want}")
    valid = dets["valid"]
    if not bool(torch.isfinite(dets["boxes"]).all()) or not bool(torch.isfinite(dets["scores"]).all()):
        raise AssertionError(f"{name}: non-finite boxes or scores")
    per_im = valid.sum(dim=1).tolist()
    cls = dets["classes"][valid]
    if min(per_im) < 1 or int(cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"{name}: detections per image {per_im}, classes outside 1..{n_fg}")
    mask_on = bool(cfg.MODEL.MASK_ON)
    if mask_on:
        keys += ("mask_prob",)
        m = cfg.MRCNN.RESOLUTION
        mp = dets["mask_prob"]
        if tuple(mp.shape) != (batch, max_out, m, m, cfg.MODEL.NUM_CLASSES) or not bool(
                ((mp >= 0) & (mp <= 1)).all()):
            raise AssertionError(f"{name}: mask_prob shape {tuple(mp.shape)} or values outside "
                                 "[0, 1]")
    counts = nms_kernel.launches, roi_align_kernel.launches
    with _plain_twins():
        ref = infer(*args)
    torch.cuda.synchronize()
    if (nms_kernel.launches, roi_align_kernel.launches) != counts:
        raise AssertionError(f"{name}: the plain-twin run launched a kernel")
    for key in keys:
        if not torch.equal(dets[key], ref[key]):
            diff = (dets[key].float() - ref[key].float()).abs()
            raise AssertionError(f"{name}: {key} differs from the plain-twin run: "
                                 f"{int((diff > 0).sum())} entries, max {float(diff.max()):.3e}")
    del ref

    # each kernel at this path's own shapes, on this batch
    said = []
    t_, post = cfg.TEST, cfg.TEST.RPN_POST_NMS_TOP_N
    with torch.inference_mode():
        x = device_normalize(cfg, args[0], args[3])
        nchw = model._features(x)
        pl = model.rpn_candidates(*model.rpn_outputs(nchw), args[1])
        fill = model.collect(*nms_levels_batched(pl, t_.RPN_NMS_THRESH, post))[2].sum(dim=1)
        bx, _, msk = stack_level_problems(pl)
        rpn_stats, _, s = _nms_at(torch, f"{name} RPN", bx, msk, t_.RPN_NMS_THRESH, post,
                                  iters, warmup)
        said.append("RPN " + s)
        out = model(x, args[1])
        cands = decode_rcnn_candidates(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                       out["bbox_pred"], args[1], args[2])
        dec_stats, _, s = _nms_at(torch, f"{name} decode", *nms.offset_by_class(*cands),
                                  t_.NMS, max_out, iters, warmup)
        said.append("decode " + s)
        feats = {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}
        box_stats = mask_stats = None
        if not model.is_rfcn:
            box_stats, s = _one_level_case(torch, f"{name} box", feats, flat_rois(out["rois"]),
                                           cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, iters, warmup)
            said.append(s)
        if cfg_path == C4_FASTER_CFG:
            # rois wider than the staging buffer: the whole canvas and large boxes
            # on the 50x84 map, C = 1024, res 14 (column chunks and bands)
            ch, cw = canvas
            big = torch.tensor([[0, 0, 0, cw - 1, ch - 1], [1, 100, 50, cw - 30, ch - 10],
                                [2, -40, -40, cw + 40, ch + 40], [3, 10, 400, cw - 1, 420],
                                [4, 600, 0, 640, ch - 1], [5, 0, 0, cw - 1, 30]] * 4,
                               dtype=torch.float32, device="cuda")
            _, s = _one_level_case(torch, f"{name} wide", feats, big, 14, 1, 1)
            said.append(s)
        if mask_on:
            mask_stats, s = _one_level_case(
                torch, f"{name} cascaded mask", feats, kept_box_rois(cfg, dets["boxes"],
                                                                     args[2])[0],
                cfg.MRCNN.ROI_XFORM_RESOLUTION, iters, warmup)
            said.append(s)
        del out, cands, nchw, feats, pl

    # the main path: counts set to 0 just before, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    times = wall_seconds(lambda: infer(*args), iters, warmup)
    launches = nms_kernel.launches, roi_align_kernel.launches
    n_batches = iters + warmup
    want = (2 * n_batches, ((not model.is_rfcn) + mask_on) * n_batches)
    if launches != want:
        raise AssertionError(f"{name}: {launches} NMS / RoIAlign launches in {n_batches} "
                             f"batches, want {want}")
    med = statistics.median(times)
    stages = rcnn_stages(cfg, model, args)
    per = {n_: [] for n_, _ in stages}
    with torch.inference_mode():
        for i in range(iters):
            _, ms = _event_ms([fn for _, fn in stages])
            for (n_, _), t in zip(stages, ms):
                per[n_].append(t)
    stage_ms = {n_: statistics.median(v) for n_, v in per.items() if n_ != "count"}
    idle, kernel_ms = _idle_share(torch, lambda: infer(*args))
    _phase(name, f"{cfg_path}: {batch}x{canvas[0]}x{canvas[1]} uint8, bf16; RPN slots filled "
           f"{fill.tolist()} of {post}, detections per image {per_im}, classes in 1..{n_fg}, "
           f"finite" + (", mask_prob (B, 100, 14, 14, 81) in [0, 1]" if mask_on else "")
           + f"; {', '.join(keys)} equal to the plain-twin run; " + "; ".join(said)
           + f"; {launches[0]} NMS and {launches[1]} RoIAlign launches in {n_batches} batches; "
           f"{batch / med:.2f} imgs/s, {1000 * med:.3f} ms a batch (median of {iters} after "
           f"{warmup} warm-up); stage device ms (CUDA events, median of {iters}): "
           + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
           + f"; kernels {kernel_ms:.2f} ms a batch, device idle {idle:.4f}",
           time.perf_counter() - t0)
    return {"imgs_per_s": batch / med, "nms_launches": launches[0],
            "roi_align_launches": launches[1], "batches": n_batches, "rpn": rpn_stats,
            "decode": dec_stats, "box": box_stats, "mask": mask_stats, "stage_ms": stage_ms}


def _ss_grads(torch, step, nchw, sampled, batch, v0up):
    """The gradients of the box loss and, for v0up, of the mask loss w.r.t.
    the detached NHWC trunk map: what each RoIAlign backward alone makes."""
    leaves = {l: f.detach().permute(0, 2, 3, 1).requires_grad_(True) for l, f in nchw.items()}
    wrt = [leaves[l] for l in sorted(leaves)]
    grads = list(torch.autograd.grad(step.box_branch(leaves, sampled)[0], wrt))
    if v0up:
        grads += torch.autograd.grad(step.mask_branch(leaves, sampled, batch), wrt)
    return grads


def _ss_step_checks(torch, name, run, seed, iters, warmup):
    """A kernel step against a plain-twin step from one state and one set of
    sampler uniforms (metrics), the training RPN NMS on the step's own
    candidates, the RoIAlign backward's trunk gradients against the plain
    backward's (two kernel runs bit-equal) and timed on the step's rois, and
    R-FCN's OHEM keep counts. Returns (said, stats, snapshot restore)."""
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import roi_align_kernel
    from sad_tpu_torch.ops.proposals import stack_level_problems
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align_bwd_plain
    from sad_tpu_torch.tools.profile_train import BENCH_LR
    from sad_tpu_torch.train.rcnn_train import box_nll, ohem_select

    cfg, step, batch, model = run.cfg, run.step, run.batch, run.model
    n = run.n_images
    v0up = bool(cfg.MODEL.MASK_ON) and not model.mask_share_res5
    params = dict(model.named_parameters())
    snap = {k: p.detach().clone() for k, p in params.items()}

    def restore():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(snap[k])
            for v in run.state.velocity.values():
                v.zero_()

    p_all = cfg.TRAIN.RPN_POST_NMS_TOP_N + batch["gt_boxes"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    uniforms = (torch.rand((n, p_all), generator=gen, device="cuda"),
                torch.rand((n, p_all), generator=gen, device="cuda"))
    m_kernel = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    counts = _kernel_counts()
    with _plain_twins():
        m_plain = step(run.state, batch, BENCH_LR, uniforms=uniforms)
    restore()
    torch.cuda.synchronize()
    if _kernel_counts() != counts:
        raise AssertionError(f"{name}: the plain step launched a kernel")
    worst = max(float((m_kernel[k] - m_plain[k]).abs() / m_plain[k].abs().clamp_min(1e-6))
                for k in m_plain)
    finite = all(bool(torch.isfinite(v)) for v in m_kernel.values())
    if sorted(m_kernel) != sorted(m_plain) or not worst <= 1e-5 or not finite:
        raise AssertionError(f"{name}: metrics of the kernel step vs the plain step: worst "
                             f"rel err {worst:.3e} (limit 1e-5), finite {finite}")
    said = [f"kernel step vs plain step from one state: metrics finite, within {worst:.2e} rel"]

    with torch.no_grad():
        nchw = step.backbone(step.inputs(batch))
        logits, deltas = model.rpn_outputs(nchw)
        pl = model.rpn_candidates(logits, deltas, batch["im_hw"], train=True)
        bx, _, msk = stack_level_problems(pl)
        boxes, valid = step.proposals(logits, deltas, batch)
        del logits, deltas
    t = cfg.TRAIN
    nms_stats, _, s = _nms_at(torch, f"{name} training RPN", bx, msk, t.RPN_NMS_THRESH,
                              t.RPN_POST_NMS_TOP_N, iters, warmup)
    said.append("training RPN " + s)
    del bx, msk, pl
    sampled = step.sample(boxes, valid, batch, uniforms)
    fg_per_im = sampled["is_fg"].sum(dim=1).tolist()
    said.append(f"proposals per image {valid.sum(dim=1).tolist()}, sampled valid "
                f"{sampled['valid'].sum(dim=1).tolist()}, fg {fg_per_im}")
    stats = {"rpn": nms_stats}
    feats = {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}
    if model.is_rfcn:
        # OHEM: each image's kept rois, OHEM_ROI_PER_IMG of its live ones
        with torch.no_grad():
            cls_score, bbox_pred = step.box_outputs(feats, sampled)
            nll, live = box_nll(cls_score, sampled["labels"].reshape(-1),
                                sampled["valid"].reshape(-1))
            keep = ohem_select(cfg, nll, live, bbox_pred, *step.box_targets(sampled), n)
        kept = keep.reshape(n, -1).sum(dim=1).long().tolist()
        lives = live.reshape(n, -1).sum(dim=1).long().tolist()
        want = [min(t.OHEM_ROI_PER_IMG, v) for v in lives]
        if kept != want:
            raise AssertionError(f"{name}: OHEM kept {kept} rois an image, want {want} "
                                 f"(live {lives})")
        said.append(f"OHEM kept {kept} of live {lives} rois an image")
        stats["ohem_kept"] = kept
        return said, stats, restore
    if cfg.MODEL.MASK_ON:
        # the target crop: the forward kernel over the (B * G, Hm, Wm, 1) rasters at the
        # mask logits' resolution (2 x 7), the fg prefix's rois
        rast, cap = batch["gt_mask_rasters"], step.mask_cap()
        bb, gg, hm, wm = rast.shape
        lvl_m = int(round(np.log2(float(batch["gt_mask_stride"]))))
        which = (torch.arange(bb, device="cuda")[:, None] * gg
                 + sampled["matched_gt"][:, :cap]).reshape(-1, 1).float()
        r5 = torch.cat([which, sampled["rois"][:, :cap].reshape(-1, 4)], dim=1)
        m_res = 2 * (cfg.MRCNN.ROI_XFORM_RESOLUTION // max(cfg.MRCNN.ROI_XFORM_RESOLUTION // 7, 1))
        stats["crop"], s = _one_level_case(
            torch, f"{name} mask target crop", {lvl_m: rast.reshape(bb * gg, hm, wm, 1).float()},
            r5, m_res, iters, warmup)
        said.append(s)
    g_kernel = _ss_grads(torch, step, nchw, sampled, batch, v0up)
    again = _ss_grads(torch, step, nchw, sampled, batch, v0up)
    with _plain_twins():
        g_plain = _ss_grads(torch, step, nchw, sampled, batch, v0up)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(g_kernel, again)):
        raise AssertionError(f"{name}: two runs of the RoIAlign backward differ")
    ref_max = max(float(g.float().abs().max()) for g in g_plain)
    gworst = 0.0
    for a, b in zip(g_kernel, g_plain):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        bad = int((err > 1e-5 * ref_max + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())).sum())
        if bad or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {bad} trunk gradient elements beyond one bf16 ulp + "
                                 f"1e-5 * max of the plain backward's")
        gworst = max(gworst, float(err.max()))
    said.append(f"the RoIAlign backward's trunk gradients within tolerance of the plain "
                f"backward's (max abs diff {gworst:.3e} of max {ref_max:.3e}), two runs "
                f"bit-equal")
    # the backward kernel, and the forward on the device later, on the step's own rois
    (lvl, f), = feats.items()
    dims, c, dtype = [tuple(f.shape[1:3])], f.shape[-1], f.dtype
    shapes = [("box_train", flat_rois(sampled["rois"]), cfg.FAST_RCNN.ROI_XFORM_RESOLUTION)]
    if v0up:
        cap = step.mask_cap()
        shapes.append(("mask_train", flat_rois(sampled["rois"][:, :cap]),
                       cfg.MRCNN.ROI_XFORM_RESOLUTION))
    for key, r5, res in shapes:
        r5 = r5.contiguous()
        lv = torch.full((r5.shape[0],), lvl, dtype=torch.int32, device="cuda")
        ok = torch.ones((r5.shape[0],), dtype=torch.bool, device="cuda")
        g = torch.randn((r5.shape[0], res, res, c), generator=gen, device="cuda").to(dtype)
        ms = _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
            g, dims, lvl, n, r5, lv, ok, 2), iters * 2, warmup)
        plain_ms = _median_ms(torch, lambda: multilevel_roi_align_bwd_plain(
            g, {lvl: dims[0]}, n, r5, lv, ok, 2), 1, 1)
        b_, _ = _roi_align_bwd_bound(dims, n, c, g.element_size(), r5.shape[0], res, 2)
        stats[f"bwd_{key}"] = {"max_abs_err": gworst, "ms": ms, "plain_ms": plain_ms, **b_}
        said.append(f"backward {key} R={r5.shape[0]} res {res} C={c}: {ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms by {b_['bound_by']})")
        fwd, s = _one_level_case(torch, f"{name} {key}", {lvl: f}, r5, res, iters, warmup)
        stats[f"fwd_{key}"] = fwd
        said.append(s)
    return said, stats, restore


def _ss_main_steps(torch, name, run, iters, warmup):
    """The main path of a single-scale step: counts set to 0 just before
    iters + warmup steps, read just after; finite metrics, every trainable
    tensor updated, frozen ones bit-identical. Returns (launches, imgs/s,
    peak GiB, said)."""
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.tools.profile_infer import wall_seconds
    from sad_tpu_torch.tools.profile_train import BENCH_LR

    cfg, step, model = run.cfg, run.step, run.model
    params = dict(model.named_parameters())
    snap = {k: p.detach().clone() for k, p in params.items()}
    frozen = {k: snap[k] for k in params if k not in set(step.names)}
    losses = []
    nms_kernel.launches = roi_align_kernel.launches = roi_align_kernel.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = wall_seconds(lambda: losses.append(step(run.state, run.batch, BENCH_LR)), iters,
                         warmup)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    n_steps = iters + warmup
    mask = bool(cfg.MODEL.MASK_ON)
    v0up = mask and not model.mask_share_res5
    box = not model.is_rfcn
    want = (n_steps, (box + mask + v0up) * n_steps, (box + v0up) * n_steps)
    if launches != want:
        raise AssertionError(f"{name}: NMS / RoIAlign forward / backward launches {launches} in "
                             f"{n_steps} steps, want {want}")
    vals = {k: [float(m[k]) for m in losses] for k in losses[0]}
    if not all(np.isfinite(v).all() for v in vals.values()):
        raise AssertionError(f"{name}: non-finite metrics {vals}")
    still = [k for k in step.names if not bool(run.state.velocity[k].any())]
    if still:
        raise AssertionError(f"{name}: {len(still)} trainable tensors got no update, e.g. "
                             f"{still[:3]}")
    moved = [k for k in frozen if not torch.equal(params[k], frozen[k])]
    if moved:
        raise AssertionError(f"{name}: frozen tensors changed: {moved[:3]}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    said = (f"{n_steps} steps, loss {vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f}"
            + (f", loss_mask {vals['loss_mask'][-1]:.4f}" if mask else "")
            + f", all {len(step.names)} trainable tensors updated, {len(frozen)} frozen "
            f"bit-identical; launches NMS {launches[0]}, RoIAlign forward {launches[1]}, "
            f"backward {launches[2]}; {run.n_images / med:.2f} imgs/s, {1000 * med:.3f} ms a "
            f"step (median of {iters} after {warmup} warm-up), peak {peak:.2f} GiB")
    return launches, run.n_images / med, peak, said


def phase_ss_train(torch, name, cfg_path, seed, groups, iters, warmup, v0up_too=False):
    """A single-scale R-CNN's training step at full width and depth on its
    canvas, bf16, LR 1e-6 (profile_train.seeded_rcnn_train_step): the checks
    of _ss_step_checks, then the main path, stage ms and idle; with
    ``v0up_too`` the same model with the v0up mask head runs its checks and
    one main-path step as well."""
    from sad_tpu_torch.tools.profile_train import BENCH_LR, rcnn_stage_ms, seeded_rcnn_train_step

    t0 = time.perf_counter()
    canvas = SS_CANVAS[cfg_path]
    run = seeded_rcnn_train_step(os.path.join(REPO, cfg_path), seed=seed, n_groups=groups,
                                 device="cuda")
    n = run.n_images
    if tuple(run.batch["data_u8"].shape) != (n, *canvas, 3):
        raise AssertionError(f"{name}: canvas {tuple(run.batch['data_u8'].shape)}")
    said, stats, restore = _ss_step_checks(torch, name, run, seed, iters, warmup)
    restore()
    per = [rcnn_stage_ms(run, BENCH_LR) for _ in range(iters)]
    restore()
    stage_ms = {k: statistics.median(p[k] for p in per) for k in per[0]}
    idle, kernel_ms = _idle_share(torch, lambda: run.step(run.state, run.batch, BENCH_LR))
    launches, imgs, peak, s = _ss_main_steps(torch, name, run, iters, warmup)
    said.append(s)
    said.append("stage device ms (CUDA events, median of "
                f"{iters}): " + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
                + f"; kernels {kernel_ms:.2f} ms a step, device idle {idle:.4f}")
    out = {"imgs_per_s": imgs, "launches": launches, "steps": iters + warmup, "peak": peak,
           "stage_ms": stage_ms, **stats}
    del run
    torch.cuda.empty_cache()
    if v0up_too:
        run = seeded_rcnn_train_step(os.path.join(REPO, cfg_path), seed=seed + 1,
                                     n_groups=groups, device="cuda", opts=V0UP_OPTS)
        s_v0up, st, restore = _ss_step_checks(torch, f"{name} v0up", run, seed + 1, iters,
                                              warmup)
        restore()
        la, imgs_v, peak_v, s = _ss_main_steps(torch, f"{name} v0up", run, 1, 0)
        said.append("v0up (its own res5 on the fg rois): " + "; ".join(s_v0up) + "; " + s)
        out["v0up"] = {"launches": la, "steps": 1, **st}
        del run
        torch.cuda.empty_cache()
    _phase(name, f"{cfg_path}: {n}x{canvas[0]}x{canvas[1]} uint8, G={groups}, bf16, LR "
           f"{BENCH_LR}; " + "; ".join(said), time.perf_counter() - t0)
    return out


def phase_c4_test_net(torch, seed, data_root):
    """The Mask R-50-C4 through test_net on the synthetic val split's first
    8 images (--range 0 8), boxes and masks evaluated; byte-identical to the
    plain-twin run. Runs go to a temporary directory under ``data_root``."""
    import tempfile

    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0, ("smoke_val",))
    cfg = load_cfg(os.path.join(REPO, C4_MASK_CFG))
    model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    b = random_canvases(np.random.RandomState(seed), 8, _test_canvas_shapes(cfg)[0], "cuda")
    spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
    del b
    with tempfile.TemporaryDirectory(prefix="c4_test_net_", dir=data_root) as tmp:
        r = _test_net_run(torch, "c4_mask", C4_MASK_CFG, model, tmp, (0, 8))
    del model
    torch.cuda.empty_cache()
    res, t = r["results"], r["timing"]
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm",
            "ARl")
    want = list(keys) + [f"segm_{k}" for k in keys]
    if sorted(res) != sorted(want) or not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"c4_test_net: results.json {res}")
    nms_l, roi_l = r["launches"]
    if (nms_l, roi_l) != (2 * t["batches"], 2 * t["batches"]):
        raise AssertionError(f"c4_test_net: {nms_l} NMS / {roi_l} RoIAlign launches in "
                             f"{t['batches']} batches, want 2 and 2 a batch")
    imgs = t["images"] / t["wall"]
    _phase("c4_test_net", f"{C4_MASK_CFG} through test_net --range 0 8 on smoke_val (seeded "
           f"weights, output layers spread, a native pickle through --weights): "
           f"{t['images']} images in {t['batches']} batches, {r['n_dets']} detections with "
           f"RLE masks; bbox_results.json and results.json byte-identical to the plain-twin "
           f"run; the 24 bbox and segm metrics finite (AP {res['AP']:.4f}, segm AP "
           f"{res['segm_AP']:.4f}); launches NMS {nms_l}, RoIAlign {roi_l}; dataset {imgs:.2f} "
           f"imgs/s; ms a batch: {_split_line(t)}; eval bbox {t['eval_bbox']:.2f} s, segm "
           f"{t['eval_segm']:.2f} s; device idle {r['idle']:.4f}", time.perf_counter() - t0)
    return {"launches": r["launches"], "batches": t["batches"], "imgs_per_s": imgs}


def phase_vgg16(torch, seed, batch, iters, warmup):
    """VGG16 Faster R-CNN serving and one training step, and the RoIAlign
    forward at VGG_CNN_M_1024's shape (C = 1024, res 7) on a seeded map of
    the 608x1024 canvas (no main path serves that body here)."""
    t0 = time.perf_counter()
    infer = phase_ss_infer(torch, "vgg16_rcnn_infer", VGG16_CFG, seed, batch, iters, warmup)
    train = phase_ss_train(torch, "vgg16_rcnn_train", VGG16_CFG, seed + 1, SS_GROUPS, 1, 0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feat = torch.randn((batch, 38, 64, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    rois, _ = _edge_rois(torch, np.random.RandomState(seed), batch, (608, 1024), 2400)
    vggm, s = _one_level_case(torch, "VGG_CNN_M_1024 shape", {4: feat}, rois, 7, iters, warmup)
    _phase("vgg16_rcnn", s, time.perf_counter() - t0)
    return {"infer": infer, "train": train, "vgg_cnn_m": vggm}


LOOP_WORKERS = 6  # DATA_LOADER.NUM_PROCESSES: the card's host has 8 cores
LOOP_WARMUP = 3  # loop iterations before the timed ones


def _loop_opts(out_dir, *extra):
    """train_net options of the loop phases: profile_train's BENCH_OPTS, bs 8
    (4 groups of TRAIN.IMS_PER_BATCH 2), LR 1e-6, the synthetic COCO, a
    snapshot every 4 iterations (TRAIN.SNAPSHOT_ITERS / NUM_GPUS)."""
    from sad_tpu_torch.tools.profile_train import BENCH_LR, BENCH_OPTS

    return BENCH_OPTS + [
        "NUM_GPUS", "4", "OUTPUT_DIR", out_dir, "TRAIN.DATASETS", "('smoke_lab',)",
        "SOLVER.BASE_LR", str(BENCH_LR), "TRAIN.SNAPSHOT_ITERS", "16",
        "DATA_LOADER.NUM_PROCESSES", str(LOOP_WORKERS)] + list(extra)


@contextlib.contextmanager
def _deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (warning where an op has none), for a bit-for-bit
    comparison of two runs; restored after."""
    prior = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prior[:2]
        torch.use_deterministic_algorithms(prior[2])


def _run_dir(out_dir, dataset="smoke_lab"):
    return os.path.join(out_dir, "train", dataset)


def _check_run_files(name, out_dir, snapshots, dataset="smoke_lab"):
    files = sorted(os.listdir(_run_dir(out_dir, dataset)))
    want = sorted(["cfg.yaml", "model_final.pkl", "stats.jsonl"]
                  + [f"model_iter{i}.pkl" for i in snapshots])
    if files != want:
        raise AssertionError(f"{name}: run files {files}, want {want}")
    with open(os.path.join(_run_dir(out_dir, dataset), "stats.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    if not lines or not all(np.isfinite(ln["loss"]) for ln in lines):
        raise AssertionError(f"{name}: stats.jsonl losses {[ln['loss'] for ln in lines]}")
    return lines


def _check_noop(torch, name, train_net, argv, out_dir, max_iter):
    """A second invocation on a finished run's directory trains nothing,
    launches no kernel and leaves model_final.pkl as it was."""
    final = os.path.join(_run_dir(out_dir), "model_final.pkl")
    mtime = os.path.getmtime(final)
    before = _all_counts()
    again = train_net.main(argv)
    if again.start_iter != max_iter or again.iter_seconds or _all_counts() != before or (
            os.path.getmtime(final) != mtime):
        raise AssertionError(f"{name}: a second invocation was not a no-op")
    del again


def _check_resume(torch, name, train_net, argv_for, root, snap, max_iter):
    """Under _deterministic: an uninterrupted run ``argv_for(dir, max_iter)``
    and a run in a fresh directory that holds only its
    model_iter{snap}.pkl; their final parameters and momenta must be
    bit-equal."""
    from sad_tpu_torch.train.checkpoint import load_checkpoint

    whole_dir, resumed_dir = os.path.join(root, "whole"), os.path.join(root, "resumed")
    snap_file = f"model_iter{snap}.pkl"
    with _deterministic(torch):
        whole = train_net.main(argv_for(whole_dir, max_iter))
        os.makedirs(_run_dir(resumed_dir))
        os.link(os.path.join(_run_dir(whole_dir), snap_file),
                os.path.join(_run_dir(resumed_dir), snap_file))
        resumed = train_net.main(argv_for(resumed_dir, max_iter))
    if resumed.start_iter != snap + 1 or len(resumed.iter_seconds) != max_iter - snap - 1:
        raise AssertionError(f"{name}: the resumed run started at {resumed.start_iter}")
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    differ += [k for k in whole.state.velocity
               if not torch.equal(whole.state.velocity[k], resumed.state.velocity[k])]
    final = load_checkpoint(os.path.join(_run_dir(resumed_dir), "model_final.pkl"))["iter"]
    if differ or final != max_iter:
        raise AssertionError(f"{name}: resumed at {snap + 1} != uninterrupted: {len(differ)} "
                             f"tensors differ, e.g. {differ[:3]}; final iter {final}")
    return (f"a {max_iter}-iteration run and one resumed in a fresh directory from its "
            f"model_iter{snap}.pkl end bit-identical ({len(a) + len(whole.state.velocity)} "
            f"parameter and momentum tensors; deterministic cuDNN)")


def _all_counts():
    from sad_tpu_torch.ops import cls_loss_kernel

    return _kernel_counts() + (cls_loss_kernel.fwd_launches, cls_loss_kernel.bwd_launches)


def _reset_counts():
    from sad_tpu_torch.ops import cls_loss_kernel, nms_kernel, roi_align_kernel

    nms_kernel.launches = roi_align_kernel.launches = roi_align_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}


def _loop_numbers(torch, result, first, last):
    """The loop's imgs/s over iterations first..last-1: from the median
    iteration, and from the window's images over its host time (stalls on the
    loader come in bursts, which the median does not see); and its host feed
    over the same iterations."""
    times = result.iter_seconds[first:last]
    med = statistics.median(times)
    n_images = result.loader.batch_images
    return {"imgs_per_s": n_images / med, "step_ms": 1e3 * med, "timed": len(times),
            "imgs_per_s_window": n_images * len(times) / sum(times),
            "thread_cpu_ms": 1e3 * statistics.median(result.iter_thread_cpu[first:last]),
            "process_cpu_ms": 1e3 * statistics.median(result.iter_process_cpu[first:last]),
            **{k: v for k, v in result.feed_summary(first, last).items() if k != "served"}}


def _ms_by_stream(numbers):
    return ", ".join(f"{k} {v:.1f}" for k, v in numbers["build_ms_median_by_stream"].items())


# the synthetic COCO splits of the workflow phases: split, labeled, seed offset, images
SMOKE_SPLITS = {"smoke_lab": ("lab", True, 0, 48), "smoke_unl": ("unl", False, 1, 48),
                "smoke_val": ("val", True, 2, 32)}


def _smoke_coco(root, seed, names=("smoke_lab", "smoke_unl")):
    """The synthetic COCO splits ``names`` under ``root``, each written by the
    first phase that asks (its time is that phase's) and registered in the
    port's catalog: 48 labeled images as smoke_lab, 48 unlabeled ones as
    smoke_unl, 32 labeled ones as smoke_val; sides 480-800. The shapes are
    of the generator's 8 categories; the jsons list 80, as COCO does, so
    that the 81-class models' detections map to categories. Returns the
    image directory of the last."""
    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.data.synth_coco import generate_synthetic_coco

    for name in names:
        split, labeled, k, n = SMOKE_SPLITS[name]
        js = os.path.join(root, f"{'instances' if labeled else 'image_info'}_{split}.json")
        img_dir = os.path.join(root, f"images_{split}")
        if not os.path.exists(js):
            img_dir, js = generate_synthetic_coco(root, split, n, seed=seed + k,
                                                  size_range=(480, 800), labeled=labeled)
            with open(js) as f:
                doc = json.load(f)
            names_by_id = {c["id"]: c["name"] for c in doc["categories"]}
            doc["categories"] = [{"id": i, "name": names_by_id.get(i, f"category{i}")}
                                 for i in range(1, 81)]
            with open(js, "w") as f:
                json.dump(doc, f)
        register_dataset(name, img_dir, js, allow_override=True)
    return img_dir


def phase_sad_train_loop(torch, seed, iters, warmup, data_root):
    """The SAD workflow through its entry points: the R-101 teacher
    pseudo-labels an unlabeled split, train_net trains the R-50 student on
    the labeled set and the pseudo-labeled one by turns, then the checks.
    Runs go to a temporary directory under ``data_root``, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="sad_train_loop_", dir=data_root) as tmp:
        return _sad_train_loop(torch, seed, iters, warmup, data_root, tmp)


def _sad_train_loop(torch, seed, iters, warmup, data_root, tmp):
    from sad_tpu_torch.config import load_cfg, register_dataset
    from sad_tpu_torch.config.config import cfg_to_yaml
    from sad_tpu_torch.data.loader import stream_for_batch
    from sad_tpu_torch.eval.test_engine import generate_pseudo_labels
    from sad_tpu_torch.models import compute_dtype, create_model
    from sad_tpu_torch.ops import cls_loss_kernel, nms_kernel
    from sad_tpu_torch.tools import train_net
    from sad_tpu_torch.tools.profile_infer import wall_seconds
    from sad_tpu_torch.tools.profile_train import BENCH_LR, BENCH_OPTS, seeded_train_step

    t0 = time.perf_counter()
    unl_dir = _smoke_coco(data_root, 0)

    # the teacher's pseudo-labels: a first pass at threshold 0 finds the
    # threshold at which every image keeps at least one box (its lowest
    # top score), the second writes the set
    tcfg = load_cfg(os.path.join(REPO, TEACHER_CFG), BENCH_OPTS)
    teacher_yaml = os.path.join(tmp, "teacher.yaml")
    with open(teacher_yaml, "w") as f:
        f.write(cfg_to_yaml(tcfg))
    # a random teacher scores every box alike: keep its top 10 an image, near
    # COCO's 7.3 objects an image, as a trained teacher's threshold would
    pl_cfg = load_cfg(os.path.join(REPO, TEACHER_CFG), BENCH_OPTS + ["TEST.DETECTIONS_PER_IM", "10"])
    teacher = create_model(pl_cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed + 1))
    teacher.to(compute_dtype(pl_cfg))
    _reset_counts()
    with _deterministic(torch):
        probe = generate_pseudo_labels(pl_cfg, teacher, "smoke_unl",
                                       os.path.join(tmp, "probe.json"), score_thresh=0.0)
    with open(probe) as f:
        top = {}
        for a in json.load(f)["annotations"]:
            top[a["image_id"]] = max(top.get(a["image_id"], 0.0), a["score"])
    if len(top) != 48:
        raise AssertionError(f"pseudo-labels: only {len(top)} of 48 images have a detection")
    thr = min(top.values())
    with _deterministic(torch):
        pl_json = generate_pseudo_labels(pl_cfg, teacher, "smoke_unl",
                                         os.path.join(tmp, "pseudo_unl.json"), score_thresh=thr)
    pl_nms = nms_kernel.launches
    del teacher
    with open(pl_json) as f:
        boxes = [a["image_id"] for a in json.load(f)["annotations"]]
    per_image = np.bincount(boxes)[1:]
    if len(set(boxes)) != 48:
        raise AssertionError(f"pseudo-labels at {thr}: {len(set(boxes))} of 48 images keep a box")
    register_dataset("smoke_pl", unl_dir, pl_json, is_pseudo_labeled=True, allow_override=True)

    # 40 iterations: the first ones draw on the queue the loader prefilled,
    # the later ones show whether the loader keeps up. Snapshots at 16 and 32
    # (iterations 15 and 31 write them) and the profiled iterations 36..38
    # stay out of both windows
    max_iter, prof_start, prof_num, early, steady = 40, 36, 2, (LOOP_WARMUP, 15), (17, 31)
    prof_dir = os.path.join(tmp, "profile")
    student = os.path.join(REPO, STUDENT_CFG)

    def argv(out_dir, n_iter, *extra):
        return ["--cfg", student, "--teacher_cfg", teacher_yaml, "--skip-test"] + _loop_opts(
            out_dir, "DISTILLATION.UNLABEL_DISTILLATION", "True",
            "DISTILLATION.UNLABEL_DATASETS", "('smoke_pl',)", "SOLVER.MAX_ITER", str(n_iter),
            *extra)

    # the main path: train_net with every count at 0 just before, read just after
    out_a = os.path.join(tmp, "a")
    run_argv = argv(out_a, max_iter, "TRAIN.SNAPSHOT_ITERS", "64", "PROFILE_DIR", prof_dir,
                    "PROFILE_START_ITER", str(prof_start), "PROFILE_NUM_ITERS", str(prof_num))
    held = torch.cuda.memory_allocated() / 2**30  # by earlier phases, not the run
    _reset_counts()
    t_run = time.perf_counter()
    result = train_net.main(run_argv)
    run_s = time.perf_counter() - t_run
    launches = _all_counts()
    by_rows = (dict(cls_loss_kernel.fwd_by_rows), dict(cls_loss_kernel.bwd_by_rows))
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    n_steps = max_iter
    if launches != (0, 0, 0, 5 * n_steps, 5 * n_steps):
        raise AssertionError(f"sad_train_loop: launches (NMS, RoIAlign fwd, bwd, cls fwd, bwd) "
                             f"{launches} in {n_steps} steps, want cls 5 + 5 a step only")
    level_rows = {lvl: result.loader.batch_images * h * w * 9 for lvl, (h, w) in LEVEL_HW.items()}
    per_level = {lvl: (by_rows[0].get(r, 0), by_rows[1].get(r, 0)) for lvl, r in level_rows.items()}
    if any(v != (n_steps, n_steps) for v in per_level.values()):
        raise AssertionError(f"sad_train_loop: cls-loss launches by level {per_level}, want one "
                             f"fwd and one bwd a level a step")
    served = result.feed_summary()["served"]
    want = [stream_for_batch(i, True) for i in range(max_iter)]
    if served != want:
        raise AssertionError(f"sad_train_loop: batch streams {served}, want {want}")
    lines = _check_run_files("sad_train_loop", out_a, (15, 31))
    fed = _loop_numbers(torch, result, *early)
    timed = _loop_numbers(torch, result, *steady)
    with open(os.path.join(prof_dir, "profile_summary.json")) as f:
        prof = json.load(f)
    del result
    _check_noop(torch, "sad_train_loop", train_net, run_argv, out_a, max_iter)
    shutil.rmtree(out_a)

    # the same configuration's step on one prebuilt batch, as profile_train times it
    run = seeded_train_step(seed=seed, n_groups=4, device="cuda")
    walls = wall_seconds(lambda: run.step(run.state, run.batch, BENCH_LR), iters, warmup)
    step_imgs = run.n_images / statistics.median(walls)
    del run
    torch.cuda.empty_cache()

    resume = _check_resume(torch, "sad_train_loop", train_net, argv, tmp, 3, 8)
    _phase("sad_train_loop", f"pseudo-labels of the R-101 teacher (top 10 an image) over 48 "
           f"unlabeled images at score {thr:.4f} (every image's lowest top score): {len(boxes)} "
           f"boxes, {per_image.min()}-{per_image.max()} an image, {pl_nms} NMS launches; "
           f"train_net R-50 student + R-101 teacher, bs 8 (G=4), {n_steps} iterations, labeled "
           f"and pseudo-labeled batches by parity ({served.count('labeled')} + "
           f"{served.count('unlabeled')}), {LOOP_WORKERS} loader processes; model_iter15/31, "
           f"model_final, stats.jsonl (loss {lines[0]['loss']:.4f} -> {lines[-1]['loss']:.4f}, "
           f"every loss finite), cfg.yaml; cls-loss launches {launches[3]} fwd + {launches[4]} "
           f"bwd, one of each a level a step; a second invocation a no-op; {resume}. "
           f"Loop, iterations {steady[0]}..{steady[1] - 1}: {timed['imgs_per_s']:.2f} imgs/s from "
           f"the median iteration ({timed['step_ms']:.2f} ms), {timed['imgs_per_s_window']:.2f} "
           f"from the window's time; iterations {early[0]}..{early[1] - 1}, on the prefilled "
           f"queue: {fed['imgs_per_s']:.2f} / {fed['imgs_per_s_window']:.2f}; an iteration's "
           f"CPU time {timed['thread_cpu_ms']:.1f} ms in the loop thread, "
           f"{timed['process_cpu_ms']:.1f} ms in the process (medians); the same "
           f"configuration's step on one prebuilt batch {step_imgs:.2f} imgs/s; host build "
           f"{timed['build_ms_median']:.1f} ms a batch (median of {timed['batches_built']}; by "
           f"stream {_ms_by_stream(timed)}), prefetch copy {timed['copy_ms_median']:.2f} ms, "
           f"{100 * timed['waited_share']:.0f} % of the window's steps waited on the loader "
           f"({timed['wait_ms_total']:.0f} ms in all; {100 * fed['waited_share']:.0f} % of the "
           f"early ones), queue depth median {timed['queue_depth_median']} (min "
           f"{timed['queue_depth_min']}); device idle {prof['device_idle_share']:.4f} over "
           f"iterations {prof_start}..{prof_start + prof_num} ({prof['kernel_ms']:.1f} ms kernels "
           f"in {prof['wall_ms']:.1f} ms, torch.profiler); peak {peak:.2f} GiB over what earlier "
           f"phases hold; train_net "
           f"{run_s:.1f} s", time.perf_counter() - t0)
    return {"launches": launches, "per_level": per_level, "loop": timed, "loop_fed": fed,
            "step_imgs": step_imgs, "idle": prof["device_idle_share"], "peak_gib": peak}


def phase_mask_rcnn_train_loop(torch, data_root):
    """Mask R-CNN R-50-FPN through train_net, then the same checks. Runs go
    to a temporary directory under ``data_root``, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mask_rcnn_train_loop_", dir=data_root) as tmp:
        return _mask_rcnn_train_loop(torch, data_root, tmp)


def _mask_rcnn_train_loop(torch, data_root, tmp):
    from sad_tpu_torch.tools import train_net

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0)
    # iteration 7 writes the snapshot; the window is the iterations after it
    max_iter, snap, window = 16, 7, (8, 16)

    def argv(out_dir, n_iter, snapshot_iters=32):
        return ["--cfg", os.path.join(REPO, MASK_CFG), "--skip-test"] + _loop_opts(
            out_dir, "SOLVER.MAX_ITER", str(n_iter), "TRAIN.SNAPSHOT_ITERS", str(snapshot_iters))

    # the main path: train_net with every count at 0 just before, read just after
    out_a = os.path.join(tmp, "a")
    run_argv = argv(out_a, max_iter)
    held = torch.cuda.memory_allocated() / 2**30  # by earlier phases, not the run
    _reset_counts()
    result = train_net.main(run_argv)
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    want = (max_iter, 3 * max_iter, 2 * max_iter, 0, 0)
    if launches != want:
        raise AssertionError(f"mask_rcnn_train_loop: launches (NMS, RoIAlign fwd, bwd, cls fwd, "
                             f"bwd) {launches} in {max_iter} steps, want {want}")
    lines = _check_run_files("mask_rcnn_train_loop", out_a, (snap,))
    if "loss_mask" not in lines[-1]:
        raise AssertionError("mask_rcnn_train_loop: no loss_mask in stats.jsonl")
    timed = _loop_numbers(torch, result, *window)
    del result
    _check_noop(torch, "mask_rcnn_train_loop", train_net, run_argv, out_a, max_iter)
    shutil.rmtree(out_a)
    # deterministic cuDNN is slow on this model: a short pair, snapshot at 2
    resume = _check_resume(torch, "mask_rcnn_train_loop", train_net,
                           lambda d, n: argv(d, n, snapshot_iters=8), tmp, 1, 4)
    _phase("mask_rcnn_train_loop", f"train_net {MASK_CFG}, bs 8 (G=4), 800x1344, {max_iter} "
           f"iterations, {LOOP_WORKERS} loader processes: model_iter{snap}, model_final, "
           f"stats.jsonl (loss {lines[0]['loss']:.4f} -> {lines[-1]['loss']:.4f}, loss_mask "
           f"{lines[-1]['loss_mask']:.4f}, every loss finite), cfg.yaml; launches NMS "
           f"{launches[0]}, RoIAlign forward {launches[1]}, backward {launches[2]}; a second "
           f"invocation a no-op; {resume}. Loop, iterations {window[0]}..{window[1] - 1}: "
           f"{timed['imgs_per_s']:.2f} imgs/s from the median iteration "
           f"({timed['step_ms']:.2f} ms), {timed['imgs_per_s_window']:.2f} from the window's "
           f"time; an iteration's CPU time {timed['thread_cpu_ms']:.1f} ms in the loop thread, "
           f"{timed['process_cpu_ms']:.1f} ms in the process; host build "
           f"{timed['build_ms_median']:.1f} ms a batch, prefetch copy "
           f"{timed['copy_ms_median']:.2f} ms, {100 * timed['waited_share']:.0f} % of the steps "
           f"waited on the loader ({timed['wait_ms_total']:.0f} ms in all), queue depth median "
           f"{timed['queue_depth_median']}; peak {peak:.2f} GiB over what earlier phases hold",
           time.perf_counter() - t0)
    return {"launches": launches, "loop": timed, "peak_gib": peak}


def _gt_as_detections(doc):
    """The split's own non-crowd ground truth as detections of score 1, with
    its polygons as RLE masks."""
    from sad_tpu_torch.utils.segms import mask_to_rle, polys_to_mask

    hw = {im["id"]: (im["height"], im["width"]) for im in doc["images"]}
    return [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
             "score": 1.0, "segmentation": mask_to_rle(polys_to_mask(a["segmentation"],
                                                                     *hw[a["image_id"]]))}
            for a in doc["annotations"] if not a["iscrowd"]]


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _test_net_run(torch, name, cfg_path, model, tmp, im_range=None, dataset="smoke_val",
                  opts=(), profile=True, twin=True):
    """test_net.main on ``model`` (saved as a native pickle, loaded through
    --weights) over ``dataset`` or its ``im_range`` with the config options
    ``opts``, with the kernels and then (with ``twin``) with their plain
    twins: the kernel run's launches, results, detections' bytes and timing,
    and with ``profile`` the device's kernel ms over the same inference loop,
    profiled."""
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.eval import test_engine
    from sad_tpu_torch.models import compute_dtype
    from sad_tpu_torch.ops import nms_kernel, roi_align_kernel
    from sad_tpu_torch.tools import test_net
    from sad_tpu_torch.tools.profile_infer import device_ms
    from sad_tpu_torch.train.checkpoint import save_checkpoint

    pkl = os.path.join(tmp, f"{name}.pkl")
    save_checkpoint(pkl, model)
    extra = ["--range", *map(str, im_range)] if im_range else []

    def run(out_dir):
        argv = ["--cfg", os.path.join(REPO, cfg_path), "--weights", pkl, *extra,
                "TEST.DATASETS", f"('{dataset}',)", *opts, "OUTPUT_DIR", out_dir]
        test_net.main(argv)
        return os.path.join(out_dir, "test", dataset)

    # the main path: the counts set to 0 just before, read just after
    _reset_counts()
    got_dir = run(os.path.join(tmp, f"{name}_kernels"))
    launches = nms_kernel.launches, roi_align_kernel.launches
    files = {}
    for fname in ("bbox_results.json", "results.json"):
        with open(os.path.join(got_dir, fname), "rb") as f:
            files[fname] = f.read()
    if twin:
        with _plain_twins():
            twin_dir = run(os.path.join(tmp, f"{name}_plain"))
        if (nms_kernel.launches, roi_align_kernel.launches) != launches:
            raise AssertionError(f"test_net {name}: the plain-twin run launched a kernel")
        for fname, got in files.items():
            with open(os.path.join(twin_dir, fname), "rb") as f:
                if f.read() != got:
                    raise AssertionError(f"test_net {name}: {fname} differs from the plain-twin "
                                         "run")
    timing = _read_json(os.path.join(got_dir, "timing.json"))
    out = {"launches": launches, "results": json.loads(files["results.json"]),
           "n_dets": len(json.loads(files["bbox_results.json"])), "timing": timing,
           "bytes": len(files["bbox_results.json"])}
    if not profile:
        return out
    # the device's kernel time over the same loop, beside the unprofiled wall
    cfg = load_cfg(os.path.join(REPO, cfg_path), ["TEST.DATASETS", f"('{dataset}',)", *opts])
    ds = CocoDataset(dataset)
    roidb = ds.get_roidb(include_gt=False)[slice(*(im_range or (None,)))]
    if cfg.TEST.PROPOSAL_FILES:
        test_engine.attach_test_proposals(cfg, roidb, dataset)
    model.to(compute_dtype(cfg))
    kernel_ms = sum(device_ms(lambda: test_engine.run_inference_on_roidb(
        cfg, model, roidb, ds.contiguous_to_json), 1, 0).values())
    return dict(out, kernel_ms=kernel_ms, idle=1.0 - kernel_ms / (1e3 * timing["wall"]))


def _split_line(t):
    n = t["batches"]
    parts = [f"{k.replace('_', ' ')} {1e3 * t[k] / n:.1f}"
             for k in ("load_resize", "device", "mask_gather", "paste", "rle", "dicts")]
    return ", ".join(parts)


def phase_test_net(torch, seed, data_root, batch_imgs):
    """The evaluation path through its entry point, test_net: the R-50
    student and Mask R-CNN R-50-FPN on a synthetic COCO val split, the COCO
    evaluator, then the checks. Runs go to a temporary directory under
    ``data_root``, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="test_net_", dir=data_root) as tmp:
        return _test_net(torch, seed, data_root, tmp, batch_imgs)


def _test_net(torch, seed, data_root, tmp, batch_imgs):
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.config.config import Config, merge_cfg_from_dict
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.coco_eval import COCOEvaluator
    from sad_tpu_torch.eval.task_evaluation import ExpectedResultsError, check_expected_results
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0, ("smoke_val",))
    doc = CocoDataset("smoke_val").dataset
    n_images = len(doc["images"])
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl",
            "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")

    # the split's own ground truth as detections scores 1.0, boxes and masks
    gt_dets = _gt_as_detections(doc)
    gt_box = COCOEvaluator(doc).evaluate(gt_dets)
    gt_segm = COCOEvaluator(doc, iou_type="segm").evaluate(gt_dets)
    if gt_box["AP"] != 1.0 or gt_segm["AP"] != 1.0:
        raise AssertionError(f"test_net: the ground truth as detections scores bbox AP "
                             f"{gt_box['AP']}, segm AP {gt_segm['AP']}, want 1.0")

    runs = {}
    # the R-50 student: random weights from the seed, the whole split
    student_cfg = load_cfg(os.path.join(REPO, STUDENT_CFG))
    model = create_model(student_cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    runs["student"] = _test_net_run(torch, "student", STUDENT_CFG, model, tmp)
    del model
    # Mask R-CNN: the output layers spread on one batch of canvases as in
    # [mask_rcnn_infer]; the first 8 images (--range), as the segm
    # evaluator decodes every detection's mask to the full image
    mask_cfg = load_cfg(os.path.join(REPO, MASK_CFG))
    model = create_model(mask_cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed + 1))
    b = random_canvases(np.random.RandomState(seed + 1), 8, _test_canvas_shapes(mask_cfg)[0],
                        "cuda")
    spread_rcnn_outputs(mask_cfg, model, b["data"], b["im_hw"], b["content_hw"])
    mask_images = 8
    runs["mask"] = _test_net_run(torch, "mask", MASK_CFG, model, tmp, (0, mask_images))
    del model, b
    torch.cuda.empty_cache()

    lines = []
    for name, r in runs.items():
        res, t = r["results"], r["timing"]
        want = list(keys) + ([f"segm_{k}" for k in keys] if name == "mask" else [])
        if sorted(res) != sorted(want) or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"test_net {name}: results.json {res}")
        nms_l, roi_l = r["launches"]
        want_l = (t["batches"], 0) if name == "student" else (2 * t["batches"], 2 * t["batches"])
        if (nms_l, roi_l) != want_l:
            raise AssertionError(f"test_net {name}: {nms_l} NMS / {roi_l} RoIAlign launches in "
                                 f"{t['batches']} batches, want {want_l}")
        imgs = t["images"] / t["wall"]
        reused = (f"{batch_imgs[name]:.2f}" if name in batch_imgs
                  else "(not measured in this run)")
        lines.append(
            f"{name}: {t['images']} images in {t['batches']} batches, {r['n_dets']} detections "
            f"({r['bytes'] / 1e6:.1f} MB of json), launches NMS {nms_l}, RoIAlign {roi_l}; "
            f"dataset {imgs:.2f} imgs/s against {reused} for a reused batch; ms a "
            f"batch: {_split_line(t)}; eval bbox {t['eval_bbox']:.2f} s"
            + (f", segm {t['eval_segm']:.2f} s" if "eval_segm" in t else "")
            + f"; device idle {r['idle']:.4f} ({r['kernel_ms']:.1f} ms kernels in "
            f"{1e3 * t['wall']:.1f} ms); AP {res['AP']:.4f}, AR100 {res['AR100']:.4f}"
            + (f", segm AP {res['segm_AP']:.4f}" if name == "mask" else ""))
        r["imgs_per_s"] = imgs

    # the EXPECTED_RESULTS gate on the student's results
    gate = merge_cfg_from_dict(Config(), {
        "EXPECTED_RESULTS": (("smoke_val", "box", "AP", 0.99),),
        "EXPECTED_RESULTS_RTOL": 0.0, "EXPECTED_RESULTS_ATOL": 0.0})
    try:
        check_expected_results(gate, {"smoke_val": {"box": runs["student"]["results"]}})
    except ExpectedResultsError:
        pass
    else:
        raise AssertionError("test_net: the EXPECTED_RESULTS gate passed an AP of "
                             f"{runs['student']['results']['AP']} against 0.99 with tolerance 0")

    _phase("test_net", f"synthetic COCO val split, {n_images} images (sides 480-800, "
           f"{len(doc['annotations'])} annotations); its ground truth as detections: bbox AP "
           f"{gt_box['AP']:.1f}, segm AP {gt_segm['AP']:.1f}; test_net --weights (native "
           f"pickles of seeded random weights): bbox_results.json and results.json "
           f"byte-identical to the plain-twin runs, every metric finite, the EXPECTED_RESULTS "
           f"gate raising on AP 0.99; " + "; ".join(lines), time.perf_counter() - t0)
    return runs


KPS_IMAGES = 16  # the keypoint split: test_net serves the first 8, train_net trains on all


def phase_keypoint_test_net(torch, seed, data_root):
    """Keypoint R-CNN through its entry points: test_net on a synthetic
    keypoint split (--range 0 8), the keypoint task of the COCO evaluator,
    then train_net for 8 iterations on the same split. Runs go to a
    temporary directory under ``data_root``, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="keypoint_test_net_", dir=data_root) as tmp:
        return _keypoint_test_net(torch, seed, data_root, tmp)


def _kps_split(data_root, seed):
    """The synthetic keypoint split smoke_kps under ``data_root``, written by
    the first phase that asks and registered in the port's catalog: one
    category (the config's person) with 5 named keypoints and a flip map;
    the 17-channel head trains on the first 5, the rest unlabeled."""
    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.data.synth_coco import generate_synthetic_coco

    js = os.path.join(data_root, "instances_kps.json")
    img_dir = os.path.join(data_root, "images_kps")
    if not os.path.exists(js):
        img_dir, js = generate_synthetic_coco(data_root, "kps", KPS_IMAGES, seed=seed,
                                              n_categories=1, size_range=(480, 800),
                                              with_keypoints=True)
    register_dataset("smoke_kps", img_dir, js, allow_override=True)


def _keypoint_test_net(torch, seed, data_root, tmp):
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools import train_net
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs
    from sad_tpu_torch.tools.profile_train import BENCH_LR, BENCH_OPTS

    t0 = time.perf_counter()
    _kps_split(data_root, seed)
    cfg = load_cfg(os.path.join(REPO, KEYPOINT_CFG))
    model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    b = random_canvases(np.random.RandomState(seed), 8, _test_canvas_shapes(cfg)[0], "cuda")
    spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
    del b
    r = _test_net_run(torch, "keypoint", KEYPOINT_CFG, model, tmp, (0, 8), dataset="smoke_kps")
    del model
    torch.cuda.empty_cache()
    res, t = r["results"], r["timing"]
    kp_keys = [k for k in res if k.startswith("keypoints_")]
    if len(kp_keys) < 10 or "AP" not in res or not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"keypoint_test_net: results.json {res}")
    want_l = (2 * t["batches"], 2 * t["batches"])
    if r["launches"] != want_l:
        raise AssertionError(f"keypoint_test_net: {r['launches']} NMS / RoIAlign launches in "
                             f"{t['batches']} batches, want {want_l}")
    n = t["batches"]

    # train_net on the same split: every count at 0 just before, read just after
    max_iter, snap = 8, 3
    out = os.path.join(tmp, "train")
    argv = ["--cfg", os.path.join(REPO, KEYPOINT_CFG), "--skip-test"] + BENCH_OPTS + [
        "NUM_GPUS", "4", "OUTPUT_DIR", out, "TRAIN.DATASETS", "('smoke_kps',)",
        "SOLVER.BASE_LR", str(BENCH_LR), "SOLVER.MAX_ITER", str(max_iter),
        "TRAIN.SNAPSHOT_ITERS", "16", "DATA_LOADER.NUM_PROCESSES", str(LOOP_WORKERS)]
    _reset_counts()
    result = train_net.main(argv)
    loop_launches = _all_counts()
    want = (max_iter, 2 * max_iter, 2 * max_iter, 0, 0)
    if loop_launches != want:
        raise AssertionError(f"keypoint_test_net: train_net launches (NMS, RoIAlign fwd, bwd, "
                             f"cls fwd, bwd) {loop_launches} in {max_iter} steps, want {want}")
    lines = _check_run_files("keypoint_test_net", out, (snap,), dataset="smoke_kps")
    if "loss_kps" not in lines[-1]:
        raise AssertionError("keypoint_test_net: no loss_kps in stats.jsonl")
    iter_ms = 1e3 * statistics.median(result.iter_seconds[LOOP_WARMUP:])
    del result
    _phase("keypoint_test_net", f"synthetic keypoint split smoke_kps ({KPS_IMAGES} images, "
           f"sides 480-800, 1 category, 5 keypoints with a left/right flip map); test_net "
           f"{KEYPOINT_CFG} --range 0 8 --weights (a native pickle of seeded random weights, "
           f"output layers spread): bbox_results.json (with COCO keypoint triplets) and "
           f"results.json byte-identical to the plain-twin run, {r['n_dets']} detections, "
           f"{len(res)} metrics all finite, AP {res['AP']:.4f}, keypoints_AP "
           f"{res['keypoints_AP']:.4f}, keypoints_AR {res.get('keypoints_AR', float('nan')):.4f}; "
           f"launches NMS {r['launches'][0]}, RoIAlign {r['launches'][1]} in {n} batches; ms a "
           f"batch: load + resize {1e3 * t['load_resize'] / n:.1f}, device "
           f"{1e3 * t['device'] / n:.1f}, heatmap copy {1e3 * t['kps_copy'] / n:.1f}, keypoint "
           f"decode (host) {1e3 * t['kps_decode'] / n:.1f}, dicts {1e3 * t['dicts'] / n:.1f}; "
           f"eval bbox {t['eval_bbox']:.2f} s, keypoints {t['eval_keypoints']:.2f} s; dataset "
           f"{t['images'] / t['wall']:.2f} imgs/s; device idle {r['idle']:.4f}; train_net "
           f"{max_iter} iterations (bs 8, G=4, {LOOP_WORKERS} loader processes): "
           f"model_iter{snap}, model_final, stats.jsonl (loss {lines[0]['loss']:.4f} -> "
           f"{lines[-1]['loss']:.4f}, loss_kps {lines[-1]['loss_kps']:.4f}), cfg.yaml; launches "
           f"NMS {loop_launches[0]}, RoIAlign forward {loop_launches[1]}, backward "
           f"{loop_launches[2]}; median iteration after {LOOP_WARMUP} {iter_ms:.1f} ms",
           time.perf_counter() - t0)
    return {"launches": r["launches"], "loop_launches": loop_launches, "timing": t,
            "results": res}


# --------------------------------------------------------------------------- #
# The rest of the R-CNN test path: Fast R-CNN on precomputed
# proposals, RPN-only proposals and the two-stage workflow, test-time
# augmentation with box voting and soft-NMS.

FAST_CFG = "sad_tpu_torch/configs/fast_rcnn_R-50-FPN.yaml"
RPN_CFG = "sad_tpu_torch/configs/rpn_R-50-FPN.yaml"
TTA_CFG = "sad_tpu_torch/configs/e2e_mask_rcnn_R-50-FPN_tta.yaml"
# the TTA scales cut from the YAML's eight (400..1200) to one under the canvas's
# 800 and one over it (clamped to fit): every augmentation branch at a third of
# the passes
TTA_SCALES = "(500,1100)"
TTA_OPTS = ("TEST.BBOX_AUG.SCALES", TTA_SCALES, "TEST.MASK_AUG.SCALES", TTA_SCALES)
SOFT_NMS_OPTS = ("TEST.SOFT_NMS.ENABLED", "True", "TEST.SOFT_NMS.METHOD", "linear",
                 "TEST.SOFT_NMS.SIGMA", "0.5")
# the KPS_AUG section of Detectron's test_time_aug/keypoint_rcnn_R-50-FPN_1x.yaml
KPS_AUG_OPTS = ("TEST.KPS_AUG.ENABLED", "True", "TEST.KPS_AUG.HEUR", "HM_AVG",
                "TEST.KPS_AUG.H_FLIP", "True", "TEST.KPS_AUG.SCALES", TTA_SCALES,
                "TEST.KPS_AUG.MAX_SIZE", "2000", "TEST.KPS_AUG.SCALE_H_FLIP", "True",
                "TEST.KPS_AUG.SCALE_SIZE_DEP", "True", "TEST.KPS_AUG.AREA_TH", str(180.0 ** 2))


def _nms_path(torch, scores):
    """Which path of csrc/nms.cu takes these problems, and their valid
    counts: sorted while every problem has at most ORDER_CAP valid
    candidates, else the argmax loop for those over it."""
    from sad_tpu_torch.ops.nms_kernel import ORDER_CAP

    counts = (scores > -1e29).sum(dim=1).tolist()
    over = sum(c > ORDER_CAP for c in counts)
    return ("sorted" if not over else f"argmax loop for {over} of {len(counts)}"), counts


def _nms_at(torch, name, boxes, scores, thr, max_out, iters, warmup):
    """The NMS kernel on these problems against the plain NMS, idx and valid
    exactly equal; both timed (CUDA events), the bound of this data."""
    from sad_tpu_torch.ops import nms, nms_kernel

    boxes, scores = boxes.float().contiguous(), scores.float().contiguous()
    ik, vk = nms_kernel.nms_cuda(boxes, scores, thr, max_out)
    ip, vp = nms.nms_multi_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip) or not torch.equal(vk, vp):
        raise AssertionError(f"{name}: NMS kernel != plain ({int((ik != ip).sum())} idx, "
                             f"{int((vk != vp).sum())} valid entries differ)")
    ms = _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, thr, max_out),
                    iters * 5, warmup)
    plain_ms = _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, thr, max_out),
                          max(iters // 5, 1), 1)
    path, counts = _nms_path(torch, scores)
    b = _nms_bound(*scores.shape, max_out, vk)
    said = (f"NMS N={scores.shape[0]} K={scores.shape[1]} -> {max_out} ({path}; valid an "
            f"problem {min(counts)}..{max(counts)}, {sum(counts)} in all): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
            f"{int(vk.sum())} kept, idx and valid equal to the plain NMS")
    return {"max_abs_err": float((ik - ip).abs().max()), "ms": ms, "plain_ms": plain_ms, **b,
            "path": path}, vk, said


def phase_fast_rcnn_infer(torch, seed, batch, iters, warmup, timers):
    """Fast R-CNN serving on seeded proposals, bs 8 on 800x1344."""
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.eval.rcnn_inference import decode_rcnn_candidates, fast_rcnn_outputs
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import nms, nms_kernel, roi_align_kernel
    from sad_tpu_torch.ops.proposals import map_rois_to_fpn_levels
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain
    from sad_tpu_torch.tools.profile_infer import (
        _event_ms, device_ms, rcnn_stages, seeded_inference, wall_seconds,
    )
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, FAST_CFG), seed, batch, "cuda")
    props, pvalid = args[4], args[5]
    p = cfg.TEST.PROPOSAL_LIMIT
    if tuple(args[0].shape) != (batch, *RCNN_CANVAS, 3) or tuple(props.shape) != (batch, p, 4):
        raise AssertionError(f"fast_rcnn_infer: canvas {tuple(args[0].shape)}, proposals "
                             f"{tuple(props.shape)}")
    dets = infer(*args)
    torch.cuda.synchronize()
    max_out, n_fg = cfg.TEST.DETECTIONS_PER_IM, cfg.MODEL.NUM_CLASSES - 1
    keys = ("boxes", "scores", "classes", "valid")
    valid = dets["valid"]
    per_im = valid.sum(dim=1).tolist()
    cls = dets["classes"][valid]
    if tuple(dets["boxes"].shape) != (batch, max_out, 4) or not bool(
            torch.isfinite(dets["boxes"]).all()) or min(per_im) < max_out // 2 or int(
            cls.min()) < 1 or int(cls.max()) > n_fg:
        raise AssertionError(f"fast_rcnn_infer: boxes {tuple(dets['boxes'].shape)}, detections "
                             f"per image {per_im}, classes {int(cls.min())}..{int(cls.max())}")
    counts = nms_kernel.launches, roi_align_kernel.launches
    with _plain_twins():
        ref = infer(*args)
    torch.cuda.synchronize()
    if (nms_kernel.launches, roi_align_kernel.launches) != counts:
        raise AssertionError("fast_rcnn_infer: the plain-twin run launched a kernel")
    for key in keys:
        if not torch.equal(dets[key], ref[key]):
            raise AssertionError(f"fast_rcnn_infer: {key} differs from the plain-twin run")
    del ref

    with torch.inference_mode():
        x = device_normalize(cfg, args[0], args[3])
        # the RoIAlign forward at R = B x P on the proposals: bit for bit
        feats = {l: f.contiguous() for l, f in model.roi_features(model.backbone(x)).items()}
        f = cfg.FPN
        rois5 = flat_rois(props).contiguous()
        lv = map_rois_to_fpn_levels(rois5[:, 1:], f.ROI_MIN_LEVEL, f.ROI_MAX_LEVEL,
                                    f.ROI_CANONICAL_SCALE, f.ROI_CANONICAL_LEVEL)
        ok = pvalid.reshape(-1)
        res, sr = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO
        roi_err, _ = _roi_align_check(torch, f"fast_rcnn R={rois5.shape[0]}", feats, rois5, lv,
                                      ok, res, sr)
        roi_ms = _median_ms(torch, lambda: multilevel_roi_align(feats, rois5, lv, ok, res, sr),
                            iters * 2, warmup)
        roi_plain_ms = _median_ms(
            torch, lambda: multilevel_roi_align_plain(feats, rois5, lv, ok, res, sr), iters, 1)
        roi_b, _, _ = roi_align_bound(feats, rois5, lv, ok, res, sr)
        roi_stats = {"max_abs_err": roi_err, "ms": roi_ms, "plain_ms": roi_plain_ms, **roi_b}
        timers[f"fast_rcnn:R={rois5.shape[0]}"] = (
            lambda: multilevel_roi_align(feats, rois5, lv, ok, res, sr), roi_stats)
        roi_levels = torch.bincount(lv, minlength=6)[2:].tolist()
        # the detection NMS at its shape: B problems of P x 80 class-offset candidates
        out = fast_rcnn_outputs(cfg, model, x, props, pvalid)
        cands = decode_rcnn_candidates(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                       out["bbox_pred"], args[1], args[2])
        del out
        boxes, scores = nms.offset_by_class(*cands)
    nms_stats, _, nms_said = _nms_at(torch, "fast_rcnn_infer decode", boxes, scores,
                                     cfg.TEST.NMS, max_out, iters, warmup)
    del boxes, scores, cands
    stages = rcnn_stages(cfg, model, args)
    per = {n: [] for n, _ in stages}
    with torch.inference_mode():
        for i in range(iters + warmup):
            _, ms = _event_ms([fn for _, fn in stages])
            if i >= warmup:
                for (n, _), t in zip(stages, ms):
                    per[n].append(t)
    stage_ms = {n: statistics.median(v) for n, v in per.items() if n != "count"}

    # the main path: counts set to 0 just before, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    times = wall_seconds(lambda: infer(*args), iters, warmup)
    launches = nms_kernel.launches, roi_align_kernel.launches
    n_batches = iters + warmup
    if launches != (n_batches, n_batches):
        raise AssertionError(f"fast_rcnn_infer: {launches} NMS / RoIAlign launches in "
                             f"{n_batches} batches, want one of each a batch")
    med = statistics.median(times)
    kernel_ms = sum(device_ms(lambda: infer(*args), 5, 1).values())
    _phase("fast_rcnn_infer", f"{FAST_CFG}: {batch}x{RCNN_CANVAS[0]}x{RCNN_CANVAS[1]} uint8, "
           f"bf16, {p} seeded proposals an image (rois per level P2..P5 {roi_levels}); "
           f"detections per image {per_im}, classes in 1..{n_fg}, finite; {', '.join(keys)} "
           f"equal to the plain-twin run; RoIAlign R={rois5.shape[0]} res {res}: bit-equal to "
           f"the plain twin, kernel {roi_ms:.4f} ms, plain {roi_plain_ms:.4f} ms, bound "
           f"{roi_b['bound_ms']:.4f} ms by {roi_b['bound_by']}; decode {nms_said}; "
           f"{launches[0]} NMS and {launches[1]} RoIAlign launches in {n_batches} batches; "
           f"{batch / med:.2f} imgs/s, {1e3 * med:.3f} ms a batch (median of {iters} after "
           f"{warmup} warm-up); stage device ms (CUDA events, median of {iters}): "
           + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
           + f"; kernels {kernel_ms:.3f} ms a batch (torch.profiler), device idle "
           f"{1.0 - kernel_ms / (1e3 * med):.4f}", time.perf_counter() - t0)
    return {"imgs_per_s": batch / med, "nms_launches": launches[0],
            "roi_align_launches": launches[1], "roi_stats": roi_stats,
            "nms_stats": nms_stats, "stage_ms": stage_ms}


def phase_proposal_pipeline(torch, seed, data_root, iters, warmup):
    """The two-stage workflow through its entry points on the synthetic val
    split: test_net with the RPN-only config writes rpn_proposals.pkl and
    its recall, train_net trains Fast R-CNN on that file, test_net serves
    Fast R-CNN on it. Runs go to a temporary directory under ``data_root``."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="proposal_pipeline_", dir=data_root) as tmp:
        return _proposal_pipeline(torch, seed, data_root, tmp, iters, warmup)


def _proposal_pipeline(torch, seed, data_root, tmp, iters, warmup):
    import pickle

    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval import rpn_generator
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import compute_dtype, create_model
    from sad_tpu_torch.ops.proposals import stack_level_problems
    from sad_tpu_torch.tools import test_net, train_net
    from sad_tpu_torch.tools.profile_infer import seeded_proposals, spread_rcnn_outputs
    from sad_tpu_torch.tools.profile_train import BENCH_LR, BENCH_OPTS
    from sad_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0, ("smoke_val",))
    split = _landscape_eight("smoke_val")  # one batch: the plain NMS takes ~1 s a batch
    roidb = CocoDataset(split).get_roidb(include_gt=False)
    n_batches = 1

    # 1. RPN-only: seeded weights, the RPN's outputs spread
    cfg = load_cfg(os.path.join(REPO, RPN_CFG))
    model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    b = random_canvases(np.random.RandomState(seed), 8, _test_canvas_shapes(cfg)[0], "cuda")
    spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
    pkl = os.path.join(tmp, "rpn.pkl")
    save_checkpoint(pkl, model)
    model.to(compute_dtype(cfg))
    # the proposal NMS at its shape on this batch: 5 levels x 8 images, each
    # level's RPN_PRE_NMS_TOP_N candidates -> RPN_POST_NMS_TOP_N slots
    with torch.inference_mode():
        logits, deltas = model.rpn_outputs(model._features(
            device_normalize(cfg, b["data"], b["content_hw"])))
        boxes, _, masked = stack_level_problems(model.rpn_candidates(logits, deltas, b["im_hw"]))
        del logits, deltas
    post = cfg.TEST.RPN_POST_NMS_TOP_N
    nms_stats, vk, nms_said = _nms_at(torch, "proposal_pipeline RPN", boxes, masked,
                                      cfg.TEST.RPN_NMS_THRESH, post, iters, warmup)
    if tuple(masked.shape) != (40, cfg.TEST.RPN_PRE_NMS_TOP_N) or bool(
            vk[:, masked.shape[1]:].any()):
        raise AssertionError(f"proposal_pipeline: problems {tuple(masked.shape)}, or a slot past "
                             f"the {masked.shape[1]} candidates came back valid")
    del boxes, masked, b
    # test_net writes the proposals and their recall: the counts at 0 just
    # before, read just after
    _reset_counts()
    rec = test_net.main(["--cfg", os.path.join(REPO, RPN_CFG), "--weights", pkl,
                         "TEST.DATASETS", f"('{split}',)", "OUTPUT_DIR", os.path.join(tmp, "rpn")])
    rpn_launches = _all_counts()
    if rpn_launches != (n_batches, 0, 0, 0, 0):
        raise AssertionError(f"proposal_pipeline: test_net rpn launches {rpn_launches} in "
                             f"{n_batches} batches, want one NMS a batch")
    prop_file = rec["proposal_file"]
    with open(prop_file, "rb") as f:
        props = pickle.load(f)
    n_props = [len(x) for x in props["boxes"]]
    if sorted(props["ids"]) != sorted(e["id"] for e in roidb) or max(n_props) > post or not (
            0.0 <= rec["ar"] <= 1.0) or not all(np.isfinite(x).all() for x in props["boxes"]):
        raise AssertionError(f"proposal_pipeline: {len(props['ids'])} images, proposals an image "
                             f"{min(n_props)}..{max(n_props)}, AR {rec['ar']}")
    # the same file from the plain NMS in this process, in test_net's dtype
    with _plain_twins():
        plain = rpn_generator.generate_rpn_on_dataset(cfg, model, split)
    if plain["ids"] != props["ids"] or not all(
            np.array_equal(a, b_) for a, b_ in zip(plain["boxes"], props["boxes"])):
        raise AssertionError("proposal_pipeline: rpn_proposals.pkl differs from the plain-NMS "
                             "run's proposals")
    del model
    torch.cuda.empty_cache()

    # 2. Fast R-CNN trained on the file: spread seeded weights as TRAIN.WEIGHTS
    fcfg = load_cfg(os.path.join(REPO, FAST_CFG))
    fmodel = create_model(fcfg, "cuda", torch.Generator(device="cuda").manual_seed(seed + 1))
    b = random_canvases(np.random.RandomState(seed + 1), 8, _test_canvas_shapes(fcfg)[0], "cuda")
    spread_rcnn_outputs(fcfg, fmodel, b["data"], b["im_hw"], b["content_hw"], *seeded_proposals(
        np.random.RandomState(seed + 2), b["content_hw"], fcfg.TEST.PROPOSAL_LIMIT, "cuda"))
    del b
    init = os.path.join(tmp, "fast_init.pkl")
    save_checkpoint(init, fmodel)
    del fmodel
    max_iter, snap = 8, 3
    out = os.path.join(tmp, "train")
    argv = ["--cfg", os.path.join(REPO, FAST_CFG), "--skip-test"] + BENCH_OPTS + [
        "NUM_GPUS", "4", "OUTPUT_DIR", out, "TRAIN.DATASETS", f"('{split}',)",
        "TRAIN.PROPOSAL_FILES", f"('{prop_file}',)", "TRAIN.WEIGHTS", init,
        "SOLVER.BASE_LR", str(BENCH_LR), "SOLVER.MAX_ITER", str(max_iter),
        "TRAIN.SNAPSHOT_ITERS", "16", "DATA_LOADER.NUM_PROCESSES", str(LOOP_WORKERS)]
    _reset_counts()
    result = train_net.main(argv)
    train_launches = _all_counts()
    if train_launches != (0, max_iter, max_iter, 0, 0):
        raise AssertionError(f"proposal_pipeline: train_net launches (NMS, RoIAlign fwd, bwd, cls "
                             f"fwd, bwd) {train_launches} in {max_iter} steps, want RoIAlign "
                             "forward and backward one a step")
    lines = _check_run_files("proposal_pipeline", out, (snap,), dataset=split)
    if any(k.startswith("loss_rpn") for k in lines[-1]) or "loss_cls" not in lines[-1]:
        raise AssertionError(f"proposal_pipeline: stats.jsonl keys {sorted(lines[-1])}")
    iter_ms = 1e3 * statistics.median(result.iter_seconds[LOOP_WARMUP:])
    del result

    # 3. Fast R-CNN served on the file, from the trained weights
    from sad_tpu_torch.train.checkpoint import load_reference_or_native

    fmodel = create_model(fcfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
    load_reference_or_native(os.path.join(_run_dir(out, split), "model_final.pkl"), fmodel, fcfg)
    r = _test_net_run(torch, "fast_rcnn", FAST_CFG, fmodel, tmp, dataset=split,
                      opts=("TEST.PROPOSAL_FILES", f"('{prop_file}',)"))
    del fmodel
    torch.cuda.empty_cache()
    t = r["timing"]
    if r["launches"] != (t["batches"], t["batches"]) or not all(
            np.isfinite(v) for v in r["results"].values()) or r["n_dets"] < 8:
        raise AssertionError(f"proposal_pipeline: test_net fast_rcnn launches {r['launches']} in "
                             f"{t['batches']} batches, {r['n_dets']} detections, results "
                             f"{r['results']}")
    _phase("proposal_pipeline", f"{split} (the first {len(roidb)} landscape images of "
           f"smoke_val, one batch). "
           f"RPN-only ({RPN_CFG}, seeded weights, RPN outputs spread): the proposal {nms_said}; "
           f"test_net wrote {os.path.basename(prop_file)} ({min(n_props)}..{max(n_props)} "
           f"proposals an image) equal to a plain-NMS run's, AR {rec['ar']:.4f} over "
           f"{rec['num_pos']} gt boxes (recall at IoU 0.5 {rec['recalls'][0]:.4f}), launches NMS "
           f"{rpn_launches[0]}, RoIAlign {rpn_launches[1]}; train_net {FAST_CFG} on it "
           f"(TRAIN.PROPOSAL_FILES, {max_iter} iterations, bs 8, G=4, {LOOP_WORKERS} loader "
           f"processes): model_iter{snap}, model_final, stats.jsonl without RPN losses (loss "
           f"{lines[0]['loss']:.4f} -> {lines[-1]['loss']:.4f}), launches NMS "
           f"{train_launches[0]}, RoIAlign forward {train_launches[1]}, backward "
           f"{train_launches[2]}, median iteration after {LOOP_WARMUP} {iter_ms:.1f} ms; "
           f"test_net on TEST.PROPOSAL_FILES from model_final: bbox_results.json "
           f"and results.json byte-identical to the plain-twin run, {r['n_dets']} detections, "
           f"AP {r['results']['AP']:.4f}, launches NMS {r['launches'][0]}, RoIAlign "
           f"{r['launches'][1]} in {t['batches']} batches; dataset "
           f"{t['images'] / t['wall']:.2f} imgs/s; ms a batch: {_split_line(t)}; device idle "
           f"{r['idle']:.4f}", time.perf_counter() - t0)
    return {"nms_stats": nms_stats, "rpn_launches": rpn_launches,
            "train_launches": train_launches, "test_launches": r["launches"], "recall": rec}


def phase_tta_test_net(torch, seed, data_root):
    """Test-time augmentation through test_net: Mask R-CNN with box and mask
    TTA and box voting, the same with soft-NMS, Keypoint R-CNN with keypoint
    TTA. Runs go to a temporary directory under ``data_root``."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tta_test_net_", dir=data_root) as tmp:
        return _tta_test_net(torch, seed, data_root, tmp)


def _tta_split_line(t):
    n = t["batches"]
    return ", ".join(f"{k.replace('_', ' ')} {1e3 * t[k] / n:.1f}" for k in (
        "load_resize", "device", "aug_box_passes", "aug_merge", "aug_aux_passes", "aug_combine",
        "mask_gather", "kps_copy", "kps_decode", "paste", "rle", "dicts"))


def _landscape_eight(name):
    """``name`` + '_land8': the first 8 landscape images of a registered split
    (one batch of one canvas), registered beside it."""
    from sad_tpu_torch.config import register_dataset
    from sad_tpu_torch.data.dataset import CocoDataset

    ds = CocoDataset(name)
    doc = ds.dataset
    keep = [im for im in doc["images"] if im["width"] >= im["height"]][:8]
    ids = {im["id"] for im in keep}
    js = os.path.join(os.path.dirname(ds.spec.annotation_file), f"{name}_land8.json")
    with open(js, "w") as f:
        json.dump(dict(doc, images=keep,
                       annotations=[a for a in doc["annotations"] if a["image_id"] in ids]), f)
    register_dataset(f"{name}_land8", ds.spec.image_directory, js, allow_override=True)
    return f"{name}_land8"


def _tta_test_net(torch, seed, data_root, tmp):
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0, ("smoke_val",))
    _kps_split(data_root, seed)
    val, kps = _landscape_eight("smoke_val"), _landscape_eight("smoke_kps")
    runs, lines = {}, []
    for key, cfg_path, dataset, opts, model_seed in (
            ("tta", TTA_CFG, val, TTA_OPTS, seed),
            ("tta_soft_nms", TTA_CFG, val, TTA_OPTS + SOFT_NMS_OPTS, seed),
            ("kps_aug", KEYPOINT_CFG, kps, KPS_AUG_OPTS, seed + 1)):
        cfg = load_cfg(os.path.join(REPO, cfg_path), list(opts))
        model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(model_seed))
        b = random_canvases(np.random.RandomState(model_seed), 8, _test_canvas_shapes(cfg)[0],
                            "cuda")
        spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
        del b
        r = _test_net_run(torch, key, cfg_path, model, tmp, dataset=dataset, opts=opts,
                          profile=False)
        del model
        torch.cuda.empty_cache()
        t = r["timing"]
        n = t["batches"]
        aug = cfg.TEST.BBOX_AUG
        box_passes = (1 + aug.H_FLIP + len(aug.SCALES) * (1 + aug.SCALE_H_FLIP)
                      if aug.ENABLED else 1)
        a = cfg.TEST.MASK_AUG if cfg.MODEL.MASK_ON else cfg.TEST.KPS_AUG
        aux_passes = aug.ENABLED + a.H_FLIP + len(a.SCALES) * (1 + a.SCALE_H_FLIP)
        # each box pass: the RPN and the detection NMS and the box RoIAlign; the
        # aux head's RoIAlign once a pass of it (and in the base pass without BBOX_AUG)
        want = (2 * box_passes * n, (box_passes + aux_passes + (not aug.ENABLED)) * n)
        res = r["results"]
        if r["launches"] != want or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"tta_test_net {key}: launches {r['launches']} in {n} batches, "
                                 f"want {want} ({box_passes} box passes, {aux_passes} aux "
                                 f"passes); results {res}")
        r.update(box_roi=box_passes * n, aux_roi=want[1] - box_passes * n, nms_each=box_passes * n)
        runs[key] = r
        lines.append(
            f"{key} ({cfg_path}{' ' + ' '.join(opts) if opts else ''}; {box_passes} box "
            f"passes and {aux_passes} {'mask' if cfg.MODEL.MASK_ON else 'keypoint'} passes a "
            f"batch): {r['n_dets']} detections, AP {res['AP']:.4f}"
            + (f", segm AP {res['segm_AP']:.4f}" if "segm_AP" in res else "")
            + (f", keypoints AP {res['keypoints_AP']:.4f}" if "keypoints_AP" in res else "")
            + f"; launches NMS {r['launches'][0]}, RoIAlign {r['launches'][1]} in {n} batches; "
            f"dataset {t['images'] / t['wall']:.2f} imgs/s, {t['wall']:.2f} s a batch; ms a "
            f"batch: {_tta_split_line(t)}")
    _phase("tta_test_net", "test_net on the first 8 landscape images of smoke_val / smoke_kps "
           f"(one batch), TTA cut to the scales {TTA_SCALES}, --weights (native pickles of "
           "seeded weights, output layers spread), bbox_results.json and results.json byte-identical to the plain-twin runs, every "
           "metric finite; " + "; ".join(lines),
           time.perf_counter() - t0)
    return runs


def phase_label_assign(torch, data_root):
    """The native float32 assignment pass (sad_tpu_torch/native, g++ from
    the checkout) against its numpy float32 twin, bit-equal, on the synthetic
    COCO's labeled images at both canvases (640x1024, scale 600; 512x896,
    scale 500), each image's gt boxes scaled as the minibatch builder scales
    them, on the builder's assignment grid. Host ms an image of the native
    pass, of the twin and of the whole assign_retinanet_labels. No kernel of
    the card runs here."""
    from sad_tpu_torch import native
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.anchors import assign_retinanet_labels
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.data.minibatch import RetinaNetMinibatchBuilder, compute_im_scale
    from sad_tpu_torch.native.plain import assign_overlaps_plain

    t0 = time.perf_counter()
    _smoke_coco(data_root, 0, names=("smoke_lab",))
    roidb = CocoDataset("smoke_lab").get_roidb()
    t_build = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t_build
    said, stats = [], {}
    for cfg_path in (STUDENT_CFG, STUDENT_500_CFG):
        cfg = load_cfg(os.path.join(REPO, cfg_path))
        builder = RetinaNetMinibatchBuilder(cfg)
        grid = builder._assign_grid
        flat = grid.flat_anchors()
        ch, cw = builder.landscape
        ms_native, ms_plain, ms_assign, fg = [], [], [], 0.0
        for e in roidb:
            scale = compute_im_scale(e["height"], e["width"], cfg.TRAIN.SCALES[0],
                                     cfg.TRAIN.MAX_SIZE)
            keep = (e["gt_classes"] > 0) & ~e["is_crowd"]
            gt = (e["boxes"][keep] * scale).astype(np.float32)
            t = time.perf_counter()
            got = native.assign_overlaps(flat, gt)
            ms_native.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            ref = assign_overlaps_plain(flat, gt)
            ms_plain.append(1e3 * (time.perf_counter() - t))
            for a, b in zip(got, ref):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"label_assign: {cfg_path} image {e['id']}: the native "
                                         "pass differs from its float32 twin")
            t = time.perf_counter()
            out = assign_retinanet_labels(grid, gt, e["gt_classes"][keep], ch, cw,
                                          cfg.RETINANET.POSITIVE_OVERLAP,
                                          cfg.RETINANET.NEGATIVE_OVERLAP)
            ms_assign.append(1e3 * (time.perf_counter() - t))
            fg += out[3]
        key = f"{ch}x{cw}"
        stats[key] = {"native_ms": statistics.median(ms_native),
                      "plain_ms": statistics.median(ms_plain),
                      "assign_ms": statistics.median(ms_assign)}
        said.append(f"{key} ({len(flat)} anchors): native {stats[key]['native_ms']:.2f} ms an "
                    f"image, float32 twin {stats[key]['plain_ms']:.2f}, "
                    f"assign_retinanet_labels {stats[key]['assign_ms']:.2f} (medians); "
                    f"{fg / len(roidb):.1f} fg anchors an image")
    _phase("label_assign", f"the native pass (loaded in {build_s:.2f} s, "
           f"{native.library_path().name}) bit-equal to its numpy float32 twin on all "
           f"{len(roidb)} images at both canvases; " + "; ".join(said), time.perf_counter() - t0)
    return stats


def _elementwise_ms(torch, fn, category, n=5):
    """(elementwise kernel ms, all kernel ms) a call of fn, torch.profiler
    over n calls."""
    by_cat, busy = _kernel_ms_by_category(torch, fn, n, category)
    return by_cat.get("elementwise", 0.0), busy


def _spread_affine(torch, model, seed):
    """Seeded frozen AffineChannel values away from their init (s = 1, b = 0,
    where the fold is exact), as a trained model's BN statistics are: s in
    0.5..1.5, b ~ N(0, 0.1)."""
    from sad_tpu_torch.models.resnet import AffineChannel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AffineChannel):
                m.s.copy_(torch.rand(m.s.shape, generator=gen, device="cuda") + 0.5)
                m.b.copy_(torch.randn(m.b.shape, generator=gen, device="cuda") * 0.1)


# FOLD_AFFINE against the unfolded form with the same weights. At float32 the
# two differ by rounding only: output levels within FOLD_F32_TOL of the level's
# largest magnitude, the first step's metrics within FOLD_F32_STEP relative,
# its momentum (the gradient) within FOLD_F32_GRAD in L2 of each trainable
# tensor; each of FOLD_FAULTS must read above all three. At bf16 W*s is rounded
# once more (the rounding of conv(x, W) * s goes): outputs within FOLD_BF16_TOL,
# metrics within FOLD_STEP_REL; a dropped b hides in that rounding, so the
# float32 readings are what hold the fold. Each limit lies between the sound
# reading and the smallest fault's on the H100 (PERF.md section 6)
FOLD_F32_TOL, FOLD_F32_STEP, FOLD_F32_GRAD = 2e-5, 2e-6, 1e-2
FOLD_BF16_TOL, FOLD_STEP_REL = 0.03, 1e-3
# planted faults of a fold: one conv's b dropped (early in the body, at its
# end) and one shortcut's s not applied; each is one AffineChannel of the
# folded student set to b = 0 or s = 1, restored after
FOLD_FAULTS = {"b of res2_0_branch2a dropped": ("res2_0_branch2a_bn", "b"),
               "b of res5_2_branch2c dropped": ("res5_2_branch2c_bn", "b"),
               "s of res3_0_branch1 not applied": ("res3_0_branch1_bn", "s")}


@contextlib.contextmanager
def _planted(torch, model, suffix, attr):
    """One of FOLD_FAULTS in ``model`` for the duration of the block."""
    (m,) = [m for n, m in model.named_modules() if n.endswith(suffix)]
    p = getattr(m, attr)
    keep = p.detach().clone()
    with torch.no_grad():
        p.fill_(0.0 if attr == "b" else 1.0)
    try:
        yield
    finally:
        with torch.no_grad():
            p.copy_(keep)


def _out_rel(got, want):
    """The largest |got - want| of an output level over its largest |want|."""
    return max(float((got[k][l] - want[k][l]).abs().max() / want[k][l].abs().max())
               for k in want for l in want[k])


def _fold_serving(torch, off, on, x):
    """Fold (``on``) against unfold (``off``) on the normalised batch x:
    the sound reading, each planted fault's, and whether an output level
    came out bit-equal (the fold did not run)."""
    heads = ("cls_logits", "bbox_pred")
    with torch.inference_mode():
        want, got = off(x, outputs=heads), on(x, outputs=heads)
    faults = {}
    for fault, (suffix, attr) in FOLD_FAULTS.items():
        with _planted(torch, on, suffix, attr), torch.inference_mode():
            faults[fault] = _out_rel(on(x, outputs=heads), want)
    same = any(torch.equal(got[k][l], want[k][l]) for k in want for l in want[k])
    return _out_rel(got, want), faults, same


def _fold_step(torch, runs, lr):
    """The first joint step of runs["off"] and runs["on"] (seeded alike) and
    of the folded one with each planted fault, from the same state: the
    metrics' largest relative difference and the momentum's (the gradient's)
    largest L2 difference of a trainable tensor, sound and each fault's."""
    off, on = runs["off"], runs["on"]
    a, b = off.student.state_dict(), on.student.state_dict()
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("fold_affine: the two seeded students' weights differ")
    params = dict(on.student.named_parameters())
    snap = {n: params[n].detach().clone() for n in on.step.names}  # what a step changes

    def step():
        with torch.no_grad():
            for n, p in snap.items():
                params[n].copy_(p)
            for v in on.state.velocity.values():
                v.zero_()
        return on.step(on.state, on.batch, lr)

    want = off.step(off.state, off.batch, lr)
    if sorted(step()) != sorted(want):
        raise AssertionError("fold_affine: the folded step's metrics are other ones")

    def rel(m):
        return (max(float((m[k] - want[k]).abs() / want[k].abs().clamp_min(1e-30)) for k in want),
                max(float((on.state.velocity[n] - v).norm() / v.norm().clamp_min(1e-30))
                    for n, v in off.state.velocity.items()))

    sound = rel(step())
    faults = {}
    for fault, (suffix, attr) in FOLD_FAULTS.items():
        with _planted(torch, on.student, suffix, attr):
            faults[fault] = rel(step())
    step()
    return sound, faults


def phase_fold_affine(torch, seed, batch, groups, iters, warmup):
    """FOLD_AFFINE on against off with the same weights in one process (the
    AffineChannels spread by _spread_affine): the R-50 student's serving and
    the R-50 <- R-101 joint step (float32 parameters), each at float32 and
    at bf16 compute. The readings within the stated limits, and each of
    FOLD_FAULTS above the float32 ones; at bf16 imgs/s and elementwise
    kernel ms of each, the two timed in turns (off, on, on, off)."""
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.eval.inference import device_normalize, make_inference_fn
    from sad_tpu_torch.models import compute_dtype, create_model
    from sad_tpu_torch.tools import profile_infer, profile_train
    from sad_tpu_torch.tools.profile_infer import seeded_inference, wall_seconds
    from sad_tpu_torch.tools.profile_train import BENCH_LR, seeded_train_step

    t0 = time.perf_counter()
    path = os.path.join(REPO, STUDENT_CFG)
    cfg, off_model, off_infer, args = seeded_inference(path, seed, batch, "cuda")
    _spread_affine(torch, off_model, seed)
    models = {}
    for dt in ("bfloat16", "float32"):
        for fold in ("False", "True"):
            c = load_cfg(path, ["COMPUTE_DTYPE", dt, "FOLD_AFFINE", fold])
            m = create_model(c, "cuda", torch.Generator(device="cuda").manual_seed(seed))
            m.to(compute_dtype(c)).load_state_dict(off_model.state_dict())
            models[dt, fold] = m
    on_infer = make_inference_fn(load_cfg(path, ["FOLD_AFFINE", "True"]),
                                 models["bfloat16", "True"])
    data, _, _, content_hw = args
    serve_hw = "x".join(map(str, data.shape[1:3]))
    with torch.inference_mode():
        x = device_normalize(cfg, data, content_hw)
    serve = {dt: _fold_serving(torch, models[dt, "False"], models[dt, "True"], x)
             for dt in ("float32", "bfloat16")}
    del x, models
    times = {"off": [], "on": []}
    for key in ("off", "on", "on", "off"):
        fn = (off_infer if key == "off" else on_infer)
        times[key] += wall_seconds(lambda: fn(*args), iters, warmup)
    serve_ew = {key: _elementwise_ms(torch, lambda: fn(*args), profile_infer._category)
                for key, fn in (("off", off_infer), ("on", on_infer))}
    serve_imgs = {k: batch / statistics.median(v) for k, v in times.items()}
    del off_model, off_infer, on_infer
    torch.cuda.empty_cache()

    step = {}
    for dt in ("float32", "bfloat16"):
        runs = {key: seeded_train_step(seed=seed, n_groups=groups, device="cuda",
                                       opts=["COMPUTE_DTYPE", dt, "FOLD_AFFINE", fold])
                for key, fold in (("off", "False"), ("on", "True"))}
        for r in runs.values():
            _spread_affine(torch, r.student, seed)
            _spread_affine(torch, r.teacher, seed + 1)
        step[dt] = _fold_step(torch, runs, BENCH_LR)
        if dt == "float32":
            del runs
            torch.cuda.empty_cache()
    train = {"off": [], "on": []}
    for key in ("off", "on", "on", "off"):
        r = runs[key]
        train[key] += wall_seconds(lambda: r.step(r.state, r.batch, BENCH_LR), iters, warmup)
    train_ew = {key: _elementwise_ms(torch, lambda: r.step(r.state, r.batch, BENCH_LR),
                                      profile_train._category, n=3)
                for key, r in runs.items()}
    n_img = runs["off"].n_images
    train_hw = "x".join(map(str, runs["off"].batch["data_u8"].shape[1:3]))
    del runs
    torch.cuda.empty_cache()
    out = {"serve_imgs": serve_imgs,
           "train_imgs": {k: n_img / statistics.median(v) for k, v in train.items()},
           "serve_ew": serve_ew, "train_ew": train_ew, "serve": serve, "step": step}
    fmt = lambda d: f"off {d['off'][0]:.3f} of {d['off'][1]:.3f}, on {d['on'][0]:.3f} of " \
                    f"{d['on'][1]:.3f}"  # noqa: E731
    faults = lambda d, i=None: ", ".join(  # noqa: E731
        f"{k} {v if i is None else v[i]:.3e}" for k, v in d.items())
    (s32, f32, _), (s16, f16, _) = serve["float32"], serve["bfloat16"]
    ((m32, g32), sf32), ((m16, _), sf16) = step["float32"], step["bfloat16"]
    _phase("fold_affine", f"fold vs unfold, planted faults in brackets. R-50 student serving, "
           f"{batch}x{serve_hw} uint8: float32 outputs within {s32:.3e} of max (limit "
           f"{FOLD_F32_TOL}; {faults(f32)}), bf16 {s16:.3e} (limit {FOLD_BF16_TOL}; "
           f"{faults(f16)}); bf16 imgs/s off {serve_imgs['off']:.2f}, on "
           f"{serve_imgs['on']:.2f} (medians of {2 * iters} batches each, timed off/on/on/off); "
           f"elementwise kernel ms a batch (of all kernels) {fmt(serve_ew)}. Joint step R-50 + "
           f"R-101, {n_img}x{train_hw}, G={groups}, first step: float32 metrics within "
           f"{m32:.3e} relative (limit {FOLD_F32_STEP}; {faults(sf32, 0)}) and momentum within "
           f"{g32:.3e} in L2 (limit {FOLD_F32_GRAD}; {faults(sf32, 1)}), bf16 metrics "
           f"{m16:.3e} (limit {FOLD_STEP_REL}; {faults(sf16, 0)}); bf16 imgs/s off "
           f"{out['train_imgs']['off']:.2f}, on {out['train_imgs']['on']:.2f} (medians of "
           f"{2 * iters} steps each); elementwise kernel ms a step {fmt(train_ew)} "
           f"(torch.profiler)", time.perf_counter() - t0)
    # the checks, after the line that holds every reading
    if serve["float32"][2] or serve["bfloat16"][2]:
        raise AssertionError("fold_affine serving: an output level bit-equal, the fold did "
                             "not run")
    if not (s32 <= FOLD_F32_TOL and s16 <= FOLD_BF16_TOL and m32 <= FOLD_F32_STEP
            and g32 <= FOLD_F32_GRAD and m16 <= FOLD_STEP_REL):
        raise AssertionError("fold_affine: fold against unfold outside a stated limit")
    missed = [f for f in FOLD_FAULTS if not (f32[f] > FOLD_F32_TOL and sf32[f][0] > FOLD_F32_STEP
                                             and sf32[f][1] > FOLD_F32_GRAD)]
    if missed:
        raise AssertionError(f"fold_affine: planted faults within the float32 limits: {missed}")
    return out


def _softmax_focal64(torch, logits, labels, fg_num, gamma, alpha, scale):
    """softmax_focal_loss_op.cu's forward (:55-90) and published backward
    (:96-140) in float64 on the card: the (G,) losses of (G, ..., A, C)
    logits and their gradient under a unit cotangent."""
    x = logits.double()
    p = torch.softmax(x, dim=-1)
    t = labels.long()
    np_ = fg_num.double().clamp_min(1.0).view((-1,) + (1,) * (t.dim() - 1))
    z = torch.where(t == 0, (1 - alpha) / np_, 0.0) + torch.where(t >= 1, alpha / np_, 0.0)
    pl = torch.gather(p, -1, t.clamp_min(0)[..., None])[..., 0]
    logp = torch.log(pl.clamp_min(float(np.finfo(np.float32).tiny)))
    loss = torch.where(t >= 0, -(1 - pl) ** gamma * logp * z, 0.0)
    buff = torch.where(t >= 0, (-(1 - pl) ** gamma + gamma * (1 - pl) ** (gamma - 1) * pl * logp)
                       * z, 0.0)
    onehot = (t[..., None] == torch.arange(x.shape[-1], device=x.device)).double()
    return scale * loss.flatten(1).sum(1), scale * buff[..., None] * (onehot - p)


SOFTMAX_TOL = 1e-5  # float32 against float64: of the levels' loss sum, of the largest gradient


def phase_softmax_step(torch, seed, groups, iters, warmup):
    """A seeded R-50 RetinaNet step with RETINANET.SOFTMAX (81 logits an
    anchor, the softmax focal loss): each level's loss and the gradient of
    the step's loss w.r.t. its cls logits against the float64 formula on the
    card (within SOFTMAX_TOL of the largest across levels), then warm-up + timed steps: finite losses, trainable tensors
    updated; imgs/s."""
    from sad_tpu_torch.tools.profile_infer import wall_seconds
    from sad_tpu_torch.tools.profile_train import BENCH_LR, seeded_train_step
    from sad_tpu_torch.train.train_step import _group_view, _split_anchor_axis

    t0 = time.perf_counter()
    run = seeded_train_step(os.path.join(REPO, STUDENT_CFG), None, seed=seed, n_groups=groups,
                            device="cuda",
                            opts=["MODEL.TYPE", "retinanet", "RETINANET.SOFTMAX", "True"])
    cfg, step, batch = run.student_cfg, run.step, run.batch
    s_data, _ = step.inputs(batch)
    out = step.forward(s_data)
    total, metrics = step.losses(out, None, batch)
    levels = cfg.fpn_levels()
    grads = torch.autograd.grad(total, [out["cls_logits"][l] for l in levels])
    a = cfg.num_anchors_per_cell()
    loss_diff, loss_ref, grad_diff, grad_ref = [], [], [], []
    for lvl, g in zip(levels, grads):
        x = _split_anchor_axis(out["cls_logits"][lvl].detach(), a)
        if x.shape[-1] != cfg.MODEL.NUM_CLASSES:
            raise AssertionError(f"softmax_step: {x.shape[-1]} logits an anchor")
        ref, dref = _softmax_focal64(torch, _group_view(x, groups),
                                     _group_view(batch["labels"][lvl], groups), batch["fg_num"],
                                     cfg.RETINANET.LOSS_GAMMA, cfg.RETINANET.LOSS_ALPHA,
                                     1.0 / groups)
        loss_diff.append(abs(float(metrics[f"fl_fpn{lvl}"].detach()) - float(ref.sum())))
        loss_ref.append(abs(float(ref.sum())))
        grad_diff.append(float((g.double() - dref.reshape(g.shape)).abs().max()))
        grad_ref.append(float(dref.abs().max()))
    # against the largest across levels: a level of well-classified background
    # (P7) has a loss and gradients 1e5 times smaller, where float32's 1 - p
    # keeps few digits, in the reference's CUDA op as here
    loss_err, grad_err = max(loss_diff) / sum(loss_ref), max(grad_diff) / max(grad_ref)
    if not (loss_err <= SOFTMAX_TOL and grad_err <= SOFTMAX_TOL):
        raise AssertionError(f"softmax_step: loss {loss_err:.3e} relative, cls-logit grads "
                             f"{grad_err:.3e} of max from the float64 formula (limit "
                             f"{SOFTMAX_TOL})")
    del s_data, out, total, grads
    params = dict(run.student.named_parameters())
    snap = {n: params[n].detach().clone() for n in step.names}
    losses = []
    times = wall_seconds(lambda: losses.append(step(run.state, batch, BENCH_LR)["loss"]),
                         iters, warmup)
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"softmax_step: non-finite loss {vals}")
    still = [n for n in step.names if not bool(run.state.velocity[n].any())]
    if still:
        raise AssertionError(f"softmax_step: {len(still)} trainable tensors got no update")
    moved = sum(not torch.equal(params[n], snap[n]) for n in step.names)
    med = statistics.median(times)
    canvas = "x".join(map(str, batch["data_u8"].shape[:3]))
    _phase("softmax_step", f"R-50 RetinaNet with RETINANET.SOFTMAX, {canvas} uint8, "
           f"G={groups}, bf16: the 5 levels' softmax focal losses within {loss_err:.2e} of "
           f"their sum and the cls-logit gradients within {grad_err:.2e} of the largest of "
           f"the float64 formula (limit {SOFTMAX_TOL}); {iters + warmup} steps, loss {vals[0]:.4f} -> "
           f"{vals[-1]:.4f}, all {len(step.names)} trainable tensors updated, {moved} changed; "
           f"{run.n_images / med:.2f} imgs/s ({1000 * med:.3f} ms/step)",
           time.perf_counter() - t0)
    return run.n_images / med


# --------------------------------------------------------------------------- #
# The rest of the evaluation surface: the serving export, and the VOC,
# Cityscapes and VID evaluators through test_net
# --------------------------------------------------------------------------- #

VOC_CFG = "sad_tpu_torch/configs/faster_rcnn_VGG16_voc07.yaml"
CS_CFG = "sad_tpu_torch/configs/e2e_mask_rcnn_R-50-FPN_cityscapes.yaml"
EXPORT_CALLS = 10  # timed calls of the exported and of the live program
EXPORT_TOL = 1e-5  # boxes and scores, relative to max |live|, where not bit-equal

# the exported program in a process of its own: it imports torch and the export
# module only, serves the saved batch, and counts the NMS kernel's launches of
# its timed calls
EXPORT_CHILD = r"""
import json, sys, time
import torch
import sad_tpu_torch.eval.export as export
path, inputs_path, out_path, calls = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
inputs = torch.load(inputs_path)
serve = export.load_exported(path)
out = serve(*inputs)
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, out_path)
serve(*inputs)  # warm-up
nms_kernel = sys.modules["sad_tpu_torch.ops.nms_kernel"]
nms_kernel.launches = 0
times = []
for _ in range(calls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(*inputs)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
seen = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "flax", "sad_tpu"})
print("EXPORT_CHILD " + json.dumps({"launches": nms_kernel.launches, "times": times,
                                    "imported": seen}))
"""


def _enqueue_ms(torch, fn, n):
    """Median host ms until fn returns over n calls, each started on an idle
    card (the work it enqueued may still run), and the median wall ms a call
    to the end of that work."""
    fn()
    host, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def _dispatch_us(torch, boxes, scores, thr, max_out, calls=200, rounds=5):
    """Host microseconds a call of the custom op sad_tpu_torch::nms_multi
    (ops.nms.nms_multi) and of a direct nms_kernel.nms_cuda on the same
    inputs: the medians over ``rounds`` alternating blocks of ``calls``
    enqueued calls (one synchronize a block, after its clock stops)."""
    from sad_tpu_torch.ops import nms, nms_kernel

    fns = {"op": lambda: nms.nms_multi(boxes, scores, thr, max_out),
           "direct": lambda: nms_kernel.nms_cuda(boxes, scores, thr, max_out)}
    per = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per[k].append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in per.items()}


def phase_export_serving(torch, seed, batch, iters, warmup, data_root):
    """The R-50 student's serving exported with torch.export, reloaded in a
    child process that imports only torch and the export module, against
    live serving on the same batch."""
    import subprocess
    import tempfile

    from sad_tpu_torch.eval.export import export_retinanet_inference, load_exported
    from sad_tpu_torch.eval.inference import decode_candidates, device_normalize
    from sad_tpu_torch.ops import nms, nms_kernel
    from sad_tpu_torch.tools.profile_infer import seeded_inference, wall_seconds

    t0 = time.perf_counter()
    cfg, model, infer, args = seeded_inference(os.path.join(REPO, STUDENT_CFG), seed, batch,
                                               "cuda")
    canvas = tuple(args[0].shape[1:3])
    live = infer(*args)
    torch.cuda.synchronize()
    keys = ("boxes", "scores", "classes", "valid")
    with tempfile.TemporaryDirectory(prefix="export_", dir=data_root) as tmp:
        path = os.path.join(tmp, "retinanet_R-50-FPN_student.pt2")
        t_exp = time.perf_counter()
        export_retinanet_inference(cfg, model, batch, canvas, path)
        export_s = time.perf_counter() - t_exp
        size_mb = os.path.getsize(path) / 1e6
        # live serving in this process after the export
        again = infer(*args)
        torch.cuda.synchronize()
        for k in keys:
            if not torch.equal(again[k], live[k]):
                raise AssertionError(f"export_serving: live {k} changed after the export")
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save(tuple(args), inputs)
        out_path = os.path.join(tmp, "out.pt")
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, inputs, out_path,
                               str(EXPORT_CALLS)], capture_output=True, text=True, timeout=600,
                              cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        if proc.returncode != 0:
            raise AssertionError(f"export_serving: the child process failed:\n"
                                 f"{proc.stderr[-4000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("EXPORT_CHILD ")]
        child = json.loads(line[-1][len("EXPORT_CHILD "):])
        got = torch.load(out_path)
        exported_here = load_exported(path)  # for the host's share of a call, below
    if child["imported"]:
        raise AssertionError(f"export_serving: the child imported {child['imported']}")
    if child["launches"] != EXPORT_CALLS:
        raise AssertionError(f"export_serving: {child['launches']} NMS kernel launches in "
                             f"{EXPORT_CALLS} calls of the exported program, want one a call")
    held = "bit-equal"
    for k in keys:
        a, b = got[k], live[k].cpu()
        if k in ("classes", "valid") and not torch.equal(a, b):
            raise AssertionError(f"export_serving: {k} differ from live serving in "
                                 f"{int((a != b).sum())} entries")
        if k in ("boxes", "scores") and not torch.equal(a, b):
            err = float((a - b).abs().max())
            if err > EXPORT_TOL * float(b.abs().max()):
                raise AssertionError(f"export_serving: {k} differ from live serving by {err:.3e}")
            held = f"within {EXPORT_TOL} x max|live|"
    if not bool(live["valid"].any()):
        raise AssertionError("export_serving: no detection kept")
    exp_s = statistics.median(child["times"])
    live_s = statistics.median(wall_seconds(lambda: infer(*args), EXPORT_CALLS, 1))
    # where the exported program's time goes: the host's time to enqueue a call
    # beside the call's wall, for it (loaded in this process) and for live serving
    exp_host, exp_wall = _enqueue_ms(torch, lambda: exported_here(*args), EXPORT_CALLS)
    live_host, live_wall = _enqueue_ms(torch, lambda: infer(*args), EXPORT_CALLS)
    del exported_here

    # the NMS kernel on this batch's own candidates (8 x 5000 -> 100), and the
    # custom op's dispatch against a direct call of the kernel's wrapper
    with torch.inference_mode():
        out = model(device_normalize(cfg, args[0], args[3]))
        cands = decode_candidates(cfg, out, args[1], args[2])
        boxes, scores = (t.float().contiguous() for t in nms.offset_by_class(*cands))
    nms_stats, _, said = _nms_at(torch, "export_serving decode", boxes, scores, cfg.TEST.NMS,
                                 cfg.TEST.DETECTIONS_PER_IM, iters, warmup)
    counts = nms_kernel.launches
    us = _dispatch_us(torch, boxes, scores, cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM)
    if nms_kernel.launches == counts:
        raise AssertionError("export_serving: the dispatch timing launched no kernel")
    del out, cands, boxes, scores
    _phase("export_serving", f"{STUDENT_CFG}: torch.export of device normalisation + model + "
           f"decode at {batch}x{canvas[0]}x{canvas[1]} uint8, bf16 ({export_s:.2f} s, "
           f"{size_mb:.1f} MB .pt2); reloaded in a child process importing torch and "
           f"sad_tpu_torch.eval.export only (no jax, no sad_tpu): classes and valid equal to "
           f"live serving, boxes and scores {held}; live serving after the export unchanged; "
           f"{child['launches']} NMS kernel launches in {EXPORT_CALLS} calls of the exported "
           f"program; exported {batch / exp_s:.2f} imgs/s, live {batch / live_s:.2f} imgs/s "
           f"(median of {EXPORT_CALLS}); host ms to enqueue a batch / wall ms a batch (loaded in "
           f"this process): exported {exp_host:.2f} / {exp_wall:.2f}, live {live_host:.2f} / "
           f"{live_wall:.2f}; decode {said}; host us a call: custom op "
           f"{us['op']:.1f}, direct nms_cuda {us['direct']:.1f} (dispatch "
           f"{us['op'] - us['direct']:.1f})", time.perf_counter() - t0)
    return {"launches": child["launches"], "nms_stats": nms_stats, "dispatch_us": us,
            "imgs_per_s": batch / exp_s, "live_imgs_per_s": batch / live_s,
            "enqueue_ms": {"exported": exp_host, "live": live_host}}


def _ml_roi_case(torch, name, feats, rois5, lv, ok, res, sr, iters, warmup):
    """The multilevel RoIAlign forward on these rois: bit-equal to the plain
    twin, both timed (CUDA events), the bound of this data."""
    from sad_tpu_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_plain
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound

    rois5, lv, ok = rois5.float().contiguous(), lv.int().contiguous(), ok.contiguous()
    err, _ = _roi_align_check(torch, name, feats, rois5, lv, ok, res, sr)
    ms = _median_ms(torch, lambda: multilevel_roi_align(feats, rois5, lv, ok, res, sr),
                    iters * 2, warmup)
    plain_ms = _median_ms(torch, lambda: multilevel_roi_align_plain(feats, rois5, lv, ok, res, sr),
                          max(iters // 5, 1), 1)
    b_, _, _ = roi_align_bound(feats, rois5, lv, ok, res, sr)
    c = feats[min(feats)].shape[-1]
    said = (f"RoIAlign {name} R={rois5.shape[0]} res {res} C={c}: bit-equal, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms by {b_['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b_}, said


def _dataset_batch(torch, cfg, dataset, n):
    """The first ``n`` images of ``dataset`` as one batch of the config's
    landscape test canvas, on the card: (data, im_hw, im_scale, content_hw)."""
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes, prepare_test_batch

    entries = CocoDataset(dataset).get_roidb(include_gt=False)[:n]
    b = prepare_test_batch(cfg, entries, _test_canvas_shapes(cfg)[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(b[k])).cuda()
                 for k in ("data", "im_hw", "im_scale", "content_hw"))


def _rcnn_kernels_on_batch(torch, name, cfg, model, args, iters, warmup):
    """An R-CNN test path's kernels on one batch of its own images: the RPN
    NMS and the decode NMS exactly equal to the plain NMS, the box (and mask)
    RoIAlign forward bit-equal to the plain twin, each timed beside its
    bound."""
    from sad_tpu_torch.eval.inference import device_normalize
    from sad_tpu_torch.eval.rcnn_inference import (decode_rcnn_candidates, kept_box_rois,
                                                   make_rcnn_inference_fn)
    from sad_tpu_torch.models.rcnn import flat_rois
    from sad_tpu_torch.ops import nms
    from sad_tpu_torch.ops.proposals import stack_level_problems

    t_ = cfg.TEST
    rows, said = {}, []
    with torch.inference_mode():
        dets = make_rcnn_inference_fn(cfg, model)(*args)
        x = device_normalize(cfg, args[0], args[3])
        nchw = model._features(x)
        pl = model.rpn_candidates(*model.rpn_outputs(nchw), args[1])
        bx, _, msk = stack_level_problems(pl)
        rows["rpn"], _, s = _nms_at(torch, f"{name} RPN", bx, msk, t_.RPN_NMS_THRESH,
                                    t_.RPN_POST_NMS_TOP_N, iters, warmup)
        said.append("RPN " + s)
        out = model(x, args[1])
        cands = decode_rcnn_candidates(cfg, out["rois"], out["roi_valid"], out["cls_prob"],
                                       out["bbox_pred"], args[1], args[2])
        rows["decode"], _, s = _nms_at(torch, f"{name} decode", *nms.offset_by_class(*cands),
                                       t_.NMS, t_.DETECTIONS_PER_IM, iters, warmup)
        said.append("decode " + s)
        res, sr = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION, cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO
        rois5 = flat_rois(out["rois"])
        if cfg.FPN.FPN_ON:
            feats = {l: f.contiguous() for l, f in model.roi_features(
                {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}).items()}
            rows["box"], s = _ml_roi_case(torch, f"{name} box", feats, rois5,
                                          out["roi_levels"].reshape(-1),
                                          out["roi_valid"].reshape(-1), res, sr, iters, warmup)
        else:
            feats = {l: f.permute(0, 2, 3, 1) for l, f in nchw.items()}
            rows["box"], s = _one_level_case(torch, f"{name} box", feats, rois5, res, iters,
                                             warmup, sr)
        said.append(s)
        if cfg.MODEL.MASK_ON:
            mrois, mlv = kept_box_rois(cfg, dets["boxes"], args[2])
            rows["mask"], s = _ml_roi_case(torch, f"{name} mask", feats, mrois, mlv,
                                           dets["valid"].reshape(-1),
                                           cfg.MRCNN.ROI_XFORM_RESOLUTION,
                                           cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO, iters, warmup)
            said.append(s)
        del out, cands, nchw, feats, pl, dets
    return rows, "; ".join(said)


def phase_voc_test_net(torch, seed, data_root, iters, warmup):
    """Faster R-CNN VGG16 of the VOC 2007 YAML through test_net on a seeded
    VOC2007 devkit converted by VOCDataset.as_coco_gt, evaluated by the VOC07
    11-point protocol."""
    import tempfile

    from sad_tpu_torch.config import load_cfg, register_dataset
    from sad_tpu_torch.data.synth_devkits import write_voc_devkit
    from sad_tpu_torch.data.voc_dataset import VOCDataset
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.eval.voc_eval import voc_eval_boxes
    from sad_tpu_torch.models import compute_dtype, create_model
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.tools import test_net
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="voc_", dir=data_root) as tmp:
        voc = write_voc_devkit(tmp, "2007", "test", 16, seed=seed)
        ds = VOCDataset(tmp, "2007", "test")
        gt = ds.as_coco_gt()
        js = os.path.join(tmp, "voc_2007_test.json")
        with open(js, "w") as f:
            json.dump(gt, f)
        register_dataset("voc_2007_test", os.path.join(voc, "JPEGImages"), js,
                         allow_override=True)
        n_diff = sum(a["difficult"] for a in gt["annotations"])
        gt_dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
                    "bbox": a["bbox"], "score": 1.0} for a in gt["annotations"]]
        gt_map = voc_eval_boxes(gt, gt_dets, use_07_metric=True)["mAP"]
        if abs(gt_map - 1.0) > 1e-12:
            raise AssertionError(f"voc_test_net: the ground truth as detections scores mAP "
                                 f"{gt_map}, want 1.0")
        cfg = load_cfg(os.path.join(REPO, VOC_CFG))
        model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
        b = random_canvases(np.random.RandomState(seed), 8, _test_canvas_shapes(cfg)[0], "cuda")
        spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
        del b
        r = _test_net_run(torch, "voc", VOC_CFG, model, tmp, dataset="voc_2007_test")
        res, t = r["results"], r["timing"]
        aps = {k: v for k, v in res.items() if k.startswith("AP_cat")}
        if "mAP" not in res or not aps or "AP75" in res or not all(
                np.isfinite(v) for v in res.values()):
            raise AssertionError(f"voc_test_net: results.json {res}")
        nms_l, roi_l = r["launches"]
        if (nms_l, roi_l) != (2 * t["batches"], t["batches"]):
            raise AssertionError(f"voc_test_net: {nms_l} NMS / {roi_l} RoIAlign launches in "
                                 f"{t['batches']} batches, want 2 and 1 a batch")
        # TEST.FORCE_JSON_DATASET_EVAL: the COCO evaluator on the same split
        out = os.path.join(tmp, "force_json")
        coco = test_net.main(["--cfg", os.path.join(REPO, VOC_CFG), "--weights",
                              os.path.join(tmp, "voc.pkl"), "TEST.FORCE_JSON_DATASET_EVAL",
                              "True", "OUTPUT_DIR", out])
        keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs",
                "ARm", "ARl")
        if sorted(coco) != sorted(keys):
            raise AssertionError(f"voc_test_net: FORCE_JSON_DATASET_EVAL gave {sorted(coco)}")
        model.to(compute_dtype(cfg))
        args = _dataset_batch(torch, cfg, "voc_2007_test", 8)
        rows, said = _rcnn_kernels_on_batch(torch, "voc", cfg, model, args, iters, warmup)
        del model
    torch.cuda.empty_cache()
    _phase("voc_test_net", f"{VOC_CFG} through test_net on a seeded VOC2007 devkit (16 JPEGs "
           f"500x375, {len(gt['annotations'])} objects of the 20 classes, {n_diff} difficult) "
           f"converted by VOCDataset.as_coco_gt: the ground truth as detections mAP "
           f"{gt_map:.1f}; seeded spread weights through --weights: VOC07 11-point mAP "
           f"{res['mAP']:.4f} over {len(aps)} classes, bbox_results.json and results.json "
           f"byte-identical to the plain-twin run, launches NMS {nms_l}, RoIAlign {roi_l} in "
           f"{t['batches']} batches; TEST.FORCE_JSON_DATASET_EVAL gives the 12 COCO keys (AP "
           f"{coco['AP']:.4f}); dataset {t['images'] / t['wall']:.2f} imgs/s, "
           f"{1e3 * t['wall'] / t['batches']:.1f} ms a batch, device idle {r['idle']:.4f}; on "
           f"the split's first 8 images: {said}", time.perf_counter() - t0)
    return {"launches": r["launches"], "batches": t["batches"], **rows}


CS_IMAGES = 8  # the Cityscapes val tree: one batch of 2048x1024 images


def phase_cityscapes_test_net(torch, seed, data_root, iters, warmup):
    """Mask R-CNN R-50-FPN of the Cityscapes YAML through test_net on a
    seeded gtFine val tree converted by convert_cityscapes_to_coco: the
    Cityscapes result export, then COCO bbox and segm."""
    import tempfile

    from sad_tpu_torch.config import load_cfg, register_dataset
    from sad_tpu_torch.data.synth_devkits import write_cityscapes_tree
    from sad_tpu_torch.data.synthetic import random_canvases
    from sad_tpu_torch.eval.coco_eval import COCOEvaluator
    from sad_tpu_torch.eval.rcnn_inference import make_rcnn_inference_fn
    from sad_tpu_torch.eval.test_engine import _test_canvas_shapes
    from sad_tpu_torch.models import compute_dtype, create_model
    from sad_tpu_torch.tools.convert_cityscapes_to_coco import convert_cityscapes_instance_only
    from sad_tpu_torch.tools.profile_infer import spread_rcnn_outputs

    name = "cityscapes_fine_instanceonly_seg_val"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cityscapes_", dir=data_root) as tmp:
        img_dir, _ = write_cityscapes_tree(tmp, "val", CS_IMAGES, seed=seed)
        js = convert_cityscapes_instance_only(tmp, os.path.join(tmp, "annotations"),
                                              ["gtFine_val"])["gtFine_val"]
        register_dataset(name, img_dir, js, allow_override=True)
        doc = _read_json(js)
        gt_dets = _gt_as_detections(doc)
        gt_box = COCOEvaluator(doc).evaluate(gt_dets)["AP"]
        gt_segm = COCOEvaluator(doc, iou_type="segm").evaluate(gt_dets)["AP"]
        if gt_box != 1.0 or gt_segm != 1.0:
            raise AssertionError(f"cityscapes_test_net: the ground truth as detections scores "
                                 f"bbox AP {gt_box}, segm AP {gt_segm}, want 1.0")
        cfg = load_cfg(os.path.join(REPO, CS_CFG))
        model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
        b = random_canvases(np.random.RandomState(seed), 8, _test_canvas_shapes(cfg)[0], "cuda")
        spread_rcnn_outputs(cfg, model, b["data"], b["im_hw"], b["content_hw"])
        del b
        # the plain twins are held on the served batch below: a second test_net
        # run would spend a minute more on the host (RLE, PNGs, segm) for the same
        # bytes
        r = _test_net_run(torch, "cityscapes", CS_CFG, model, tmp, dataset=name, twin=False)
        res, t = r["results"], r["timing"]
        keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs",
                "ARm", "ARl")
        want = list(keys) + [f"segm_{k}" for k in keys]
        if sorted(res) != sorted(want) or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"cityscapes_test_net: results.json {res}")
        nms_l, roi_l = r["launches"]
        if (nms_l, roi_l) != (2 * t["batches"], 2 * t["batches"]):
            raise AssertionError(f"cityscapes_test_net: {nms_l} NMS / {roi_l} RoIAlign launches "
                                 f"in {t['batches']} batches, want 2 and 2 a batch")
        got_dir = os.path.join(tmp, "cityscapes_kernels", "test", name)
        txts = sorted(f for f in os.listdir(got_dir) if f.endswith("pred.txt"))
        lines = [ln.split() for f in txts for ln in open(os.path.join(got_dir, f))]
        pngs = os.listdir(os.path.join(got_dir, "results"))
        if len(txts) != CS_IMAGES or len(lines) != r["n_dets"] or len(pngs) != r["n_dets"] or any(
                not os.path.exists(os.path.join(got_dir, p)) for p, _, _ in lines):
            raise AssertionError(f"cityscapes_test_net: {len(txts)} pred.txt, {len(lines)} lines, "
                                 f"{len(pngs)} PNGs for {r['n_dets']} detections")
        labels = sorted({int(lb) for _, lb, _ in lines})
        model.to(compute_dtype(cfg))
        args = _dataset_batch(torch, cfg, name, CS_IMAGES)
        infer = make_rcnn_inference_fn(cfg, model)
        dets = infer(*args)
        with _plain_twins():
            ref = infer(*args)
        for k in ("boxes", "scores", "classes", "valid", "mask_prob"):
            if not torch.equal(dets[k], ref[k]):
                raise AssertionError(f"cityscapes_test_net: {k} of the served batch differs "
                                     "from the plain-twin run")
        del dets, ref
        rows, said = _rcnn_kernels_on_batch(torch, "cityscapes", cfg, model, args, iters, warmup)
        del model
    torch.cuda.empty_cache()
    _phase("cityscapes_test_net", f"{CS_CFG} through test_net on a seeded gtFine val tree "
           f"({CS_IMAGES} PNGs 2048x1024, {len(doc['annotations'])} instances after the "
           f"converter dropped crowd, non-instance and degenerate polygons): the ground truth as "
           f"detections bbox AP {gt_box:.1f}, segm AP {gt_segm:.1f}; seeded spread weights "
           f"through --weights on the 1024x2048 canvas: {r['n_dets']} detections, one pred.txt "
           f"an image and one PNG a detection (label ids {labels}), the served batch's boxes, "
           f"scores, classes, valid and mask_prob equal to the plain-twin run's, the 24 bbox "
           f"and segm metrics "
           f"finite (AP {res['AP']:.4f}, segm AP {res['segm_AP']:.4f}); launches NMS {nms_l}, "
           f"RoIAlign {roi_l} in {t['batches']} batches; {1e3 * t['wall'] / t['batches']:.1f} "
           f"ms a batch (ms a batch: {_split_line(t)}; export {t['export_cityscapes']:.2f} s, "
           f"eval bbox {t['eval_bbox']:.2f} s, segm {t['eval_segm']:.2f} s), device idle "
           f"{r['idle']:.4f}; on the batch: {said}", time.perf_counter() - t0)
    return {"launches": r["launches"], "batches": t["batches"], **rows}


def phase_vid_test_net(torch, seed, data_root):
    """The R-50 student through test_net on smoke_val registered under a vid_
    name: the VID protocol's 12 metrics."""
    import tempfile

    from sad_tpu_torch.config import load_cfg, register_dataset
    from sad_tpu_torch.eval.vid_eval import evaluate_vid_detections
    from sad_tpu_torch.models import create_model

    t0 = time.perf_counter()
    img_dir = _smoke_coco(data_root, 0, ("smoke_val",))
    js = os.path.join(data_root, "instances_val.json")
    register_dataset("vid_smoke_val", img_dir, js, allow_override=True)
    doc = _read_json(js)
    gt_ap = evaluate_vid_detections(doc, _gt_as_detections(doc))["AP"]
    if gt_ap != 1.0:
        raise AssertionError(f"vid_test_net: the ground truth as detections scores AP {gt_ap}")
    cfg = load_cfg(os.path.join(REPO, STUDENT_CFG))
    model = create_model(cfg, "cuda", torch.Generator(device="cuda").manual_seed(seed))
    with tempfile.TemporaryDirectory(prefix="vid_", dir=data_root) as tmp:
        r = _test_net_run(torch, "vid", STUDENT_CFG, model, tmp, (0, 16), dataset="vid_smoke_val",
                          profile=False)
    del model
    torch.cuda.empty_cache()
    res, t = r["results"], r["timing"]
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm",
            "ARl")
    if sorted(res) != sorted(keys) or not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"vid_test_net: results.json {res}")
    if r["launches"] != (t["batches"], 0):
        raise AssertionError(f"vid_test_net: launches {r['launches']} in {t['batches']} batches")
    _phase("vid_test_net", f"{STUDENT_CFG} through test_net --range 0 16 on smoke_val registered "
           f"as vid_smoke_val: the ground truth as detections VID AP {gt_ap:.1f}; the VID "
           f"protocol's 12 metrics finite (AP {res['AP']:.4f}), bbox_results.json and "
           f"results.json byte-identical to the plain-twin run, {r['launches'][0]} NMS launches "
           f"in {t['batches']} batches", time.perf_counter() - t0)
    return {"launches": r["launches"], "batches": t["batches"]}


# phases that can be run alone with --only
# --------------------------------------------------------------------------- #
# Data parallelism: W ranks, each a process of its own (parallel.launch.spawn)
# --------------------------------------------------------------------------- #

DDP_TIMEOUT_S = 420.0  # a world's spawn: the ranks' start, builds and steps
DDP_STEPS = 2  # compared steps (the timed ones follow)
# timed steps of [ddp_joint_step] and [ddp_rcnn_step] (--iters earlier): cut to hold the whole
# script's time with the Fast R-CNN, proposal and TTA phases in (PERF.md section 6)
DDP_TIMED_STEPS = 3
# of them the steps held to DDP_TOL: the R-CNN step's first, since at its second a proposal
# near a tie flips with the first update's last bits (PERF.md §6, data parallelism); its
# second is still held to the sampler's generator state and to ranks bit-equal, and printed
DDP_HELD = {"ddp_joint_step": 2, "ddp_rcnn_step": 1}
DDP_TOL = 1e-5  # metrics (relative) and the worst parameter tensor (relative L2)
DDP_LOOP_WORKERS = 3  # loader processes a rank: two ranks share the host's 8 cores


def _ddp_world(torch):
    """(W, backend, local ranks, what ran): W = max(2, cards), NCCL with a
    card a rank, else every rank on cuda:0 over gloo."""
    from sad_tpu_torch.tools.profile_ddp import card_layout

    world = max(2, torch.cuda.device_count())
    return (world, *card_layout(world))


def _ddp_cmp(res):
    """Raise unless the W ranks match one process and hold equal parameters."""
    bad = []
    if res["metric_rel"] > DDP_TOL:
        bad.append(f"metric {res['metric_key']} {res['metric_rel']:.3e}")
    if res["param_rel_l2"] > DDP_TOL:
        bad.append(f"parameter {res['param_key']} {res['param_rel_l2']:.3e}")
    if res["unequal_across_ranks"]:
        bad.append(f"not bit-equal across the ranks: {res['unequal_across_ranks'][:3]}")
    if res["generator_unequal"]:
        bad.append(f"sampler generator not in the one process's state: "
                   f"{res['generator_unequal'][:3]}")
    return bad


def _ddp_numbers(s):
    return (f"{s['layout']}; rank step ms {_fmt(s['rank_step_ms'])} against one process's "
            f"{s['one_step_ms']:.2f}, gradient all-reduce {_fmt(s['allreduce_ms'])} ms for "
            f"{s['allreduce_bytes'] / 1e6:.1f} MB of float32 gradients, host CPU s a step "
            f"{_fmt(s['rank_cpu_s_per_step'], 3)} (one process {s['one_cpu_s_per_step']:.3f})")


def _fmt(xs, nd=2):
    return "[" + ", ".join(f"{x:.{nd}f}" for x in xs) + "]"


def phase_ddp_step(torch, name, seed, groups, iters, gpu):
    """[ddp_joint_step] (the R-50 <- R-101 joint step at full width, bs
    groups x 2, 640x1024) or [ddp_rcnn_step] (Mask R-CNN R-50-FPN, 800x1344)
    on W ranks against one process (a world of 1 over NCCL), from the same
    seeded state and batch, DDP_STEPS steps at float32 with TF32 off and
    PyTorch's own convolutions (cuDNN's float32 convolutions do not sum a
    batch of 4 as they sum one of 8: tools/profile_ddp's witness): over the
    first DDP_HELD[name] steps metrics within DDP_TOL relative and after
    them the worst parameter tensor within DDP_TOL relative L2; after every
    step parameters and momenta bit-equal across the ranks and the R-CNN
    sampler's generator in the one process's state; each rank's kernel
    launches at its own shapes; then ``iters`` timed steps with cuDNN."""
    from sad_tpu_torch.tools import profile_ddp, profile_train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    world, _, _, _ = _ddp_world(torch)
    kw = {"seed": seed, "n_groups": groups, "device": "cuda", "opts": ["COMPUTE_DTYPE", "float32"]}
    if name == "ddp_rcnn_step":
        build = profile_train.seeded_rcnn_train_step
        kw["cfg_yaml"] = os.path.join(REPO, MASK_CFG)
    else:
        build = profile_train.seeded_train_step
    steps, held = DDP_STEPS, DDP_HELD[name]
    res = profile_ddp.run_compare(build, kw, world, steps, profile_train.BENCH_LR, iters,
                                  DDP_TIMEOUT_S, held=held)
    s = profile_ddp.summary(res)
    bad = _ddp_cmp(res)
    per_rank = []
    for r in res["ranks"]:
        n, la = r["n_images"], r["launches"]
        if name == "ddp_rcnn_step":
            got = (la["nms"], la["roi_align_fwd"], la["roi_align_bwd"], la["cls_fwd"])
            want = (steps, 3 * steps, 2 * steps, 0)
        else:
            rows = sorted(n * h * w * 9 for h, w in LEVEL_HW.values())
            got = (la["nms"], la["roi_align_fwd"], sorted(la["cls_fwd_by_rows"].items()),
                   sorted(la["cls_bwd_by_rows"].items()))
            want = (0, 0, [(x, steps) for x in rows], [(x, steps) for x in rows])
        if got != want:
            bad.append(f"rank {r['rank']} launches {got}, want {want}")
        per_rank.append(la)
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    later = (f"; not held, step {held + 1}..{steps}: worst metric {res['later_metric_key']} "
             f"{res['later_metric_rel']:.3e}, parameter {res['later_param_key']} "
             f"{res['later_param_rel_l2']:.3e}" if steps > held else "")
    sampler = (", the sampler's generator in the one process's state"
               if res["one"]["generator"] else "")
    kernels = ("NMS 1, RoIAlign forward 3 and backward 2 a step" if name == "ddp_rcnn_step"
               else "one cls-loss forward and backward a level a step at the rank's rows")
    _phase(name, f"{world} ranks of {s['rank_images'][0]} images ({groups // world} loss "
           f"groups each, scaled 1/{groups}) against one process of {groups * 2} (NCCL, world "
           f"1), float32, TF32 off, cuDNN off, {steps} steps, held to {DDP_TOL:g} over the first "
           f"{held}: worst metric {res['metric_key']} {res['metric_rel']:.3e} relative, worst "
           f"parameter {res['param_key']} {res['param_rel_l2']:.3e} relative L2 (momentum "
           f"{res['velocity_key']} {res['velocity_rel_l2']:.3e}){later}; after every step "
           f"parameters and momenta bit-equal across the ranks{sampler}; launches on each rank: "
           f"{kernels}; {iters} timed steps: {_ddp_numbers(s)}; {gpu}",
           time.perf_counter() - t0)
    return {"summary": s, "launches": per_rank}


# --------------------------------------------------------------------------- #
# sad_tpu's 'model' mesh axis: image height over ranks (parallel/spatial.py)
# --------------------------------------------------------------------------- #

SPATIAL_TIMED = 3  # timed batches / steps of [spatial_infer] and [spatial_joint_step]
SPATIAL_TOL = 1e-5  # level maps, boxes and scores (of max), metrics, parameters (relative L2)
# [spatial_joint_step]: a parameter tensor beyond SPATIAL_TOL between the float32 mesh step and
# one process's is held against one process's step at float64 compute: its relative L2 error
# there may be at most SPATIAL_F64_FACTOR times the largest error that one process's own
# float32 step shows on any parameter tensor (a value that nearly cancels, such as a
# zero-initialised bias after two steps, takes most of float32's error from how its terms are
# summed, in either run; profile_spatial.against_float64)
SPATIAL_F64_FACTOR = 2.0


def _ms(xs):
    return _fmt([statistics.median(xs)]) if xs else "[]"


def phase_spatial_infer(torch, seed, batch, iters, warmup, gpu):
    """[spatial_infer]: the R-50 student at full width, bs ``batch`` on the
    640x1024 canvas, height-sharded over n_model = 2 ranks (P7's 5 rows split
    3 / 2): make_inference_fn(cfg, model, mesh) at float32 (TF32 and cuDNN
    off) against one process's serving of the same batch on the first rank;
    each level's gathered maps within SPATIAL_TOL * max, classes and valid
    equal, boxes and scores within SPATIAL_TOL * max; the NMS kernel once a
    batch on the first rank, never on the other; SPATIAL_TIMED batches with
    cuDNN. Then the decode NMS on the gathered batch's own candidates against
    the plain NMS (nms@spatial_decode)."""
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools import profile_spatial
    from sad_tpu_torch.tools.profile_ddp import card_layout

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    backend, local, note = card_layout(2)
    kw = {"cfg_path": os.path.join(REPO, STUDENT_CFG), "seed": seed, "batch": batch,
          "opts": ["COMPUTE_DTYPE", "float32"]}
    job = ("infer", {"build": profile_spatial.seeded_serving, "build_kwargs": kw, "n_data": 1,
                     "n_model": 2, "iters": SPATIAL_TIMED, "reference": True})
    first, other = (r[0] for r in spawn(profile_spatial.rank_jobs, 2, ([job],), device="cuda",
                                        backend=backend, local_ranks=local,
                                        timeout_s=DDP_TIMEOUT_S))
    bad = [f"{k} {v:.3e}" for k, v in first["level_rel"].items() if not v <= SPATIAL_TOL]
    for key in ("boxes_rel", "scores_rel"):
        if not first[key] <= SPATIAL_TOL:
            bad.append(f"{key} {first[key]:.3e}")
    if first["untied"]:
        bad.append(f"{len(first['untied'])} kept boxes differ at no tie: {first['untied'][:3]}")
    if not (first["classes_equal"] and first["valid_equal"]):
        bad.append("classes or valid differ from one process's")
    want = 1 + 2 * SPATIAL_TIMED
    if first["launches"]["nms"] != want or any(other["launches"][k] for k in ("nms", "cls_fwd")):
        bad.append(f"NMS launches {first['launches']['nms']} / {other['launches']['nms']}, want "
                   f"{want} / 0")
    if "dets" in other:
        bad.append("the second rank returned detections")
    if bad:
        raise AssertionError("spatial_infer: " + "; ".join(bad))
    ni = first["nms_inputs"]
    stats, _, said = _nms_at(torch, "nms@spatial_decode", torch.from_numpy(ni["boxes"]).cuda(),
                             torch.from_numpy(ni["scores"]).cuda(), ni["thr"], ni["max_out"],
                             iters, warmup)
    worst = max(first["level_rel"], key=first["level_rel"].get)
    ranks = [first, other]
    _phase("spatial_infer", f"{STUDENT_CFG} at float32, bs {batch} on 640x1024 over n_model = 2 "
           f"({note}; halo transport {first['transport']}), bands {first['band_rows']} / "
           f"{other['band_rows']}: the gathered level maps within {SPATIAL_TOL:g} x max of one "
           f"process's (worst {worst} {first['level_rel'][worst]:.3e}), classes and valid equal, "
           f"boxes {first['boxes_rel']:.3e} and scores {first['scores_rel']:.3e} of max, "
           f"{first['n_valid']} detections, of which {len(first['tied'])} kept another of "
           f"tied candidates (the one process's decode holds at least two of the class within "
           f"{SPATIAL_TOL:g} x max of the score, one of them the kept box: {first['tied'][:2]}); NMS kernel {first['launches']['nms']}x on the first "
           f"rank in {want} batches and 0x on the other; {SPATIAL_TIMED} timed batches with "
           f"cuDNN, medians by rank: forward ms {[_ms(r['fwd_ms']) for r in ranks]}, batch ms "
           f"{[_ms(r['batch_ms']) for r in ranks]} against one process's "
           f"{_ms(first['one_batch_ms'])}; {SPATIAL_TIMED} more with each exchange timed (a "
           f"device sync around each): halo ms {[_ms(r['halo_ms']) for r in ranks]} and bytes a "
           f"batch {[r['halo_bytes_per_batch'] for r in ranks]}, gather ms "
           f"{[_ms(r['gather_ms']) for r in ranks]}; peak GiB of the compared batch {[round(r['peak_gib'], 3) for r in ranks]} against "
           f"one process's {first['one_peak_gib']:.3f}; {said}; {gpu}", time.perf_counter() - t0)
    return {"launches": first["launches"]["nms"], "other_launches": other["launches"]["nms"],
            "nms_stats": stats}


def _band_cls_rows(torch, got, iters, warmup, where="the band's P3"):
    """The cls-loss kernels against their plain twin on a rank's own inputs
    at its band of P3 (per-image groups, the cotangents its backward got):
    sums within 1e-5 relative, dx within 1e-5 * max|dx|; both timed after an
    L2 flush, and their bounds."""
    from sad_tpu_torch.ops import cls_loss_kernel as K
    from sad_tpu_torch.ops.fused_losses import cls_losses_bwd_plain, cls_losses_fwd_plain

    x, pt, labels, gf, gd = (torch.from_numpy(got[k]).cuda()
                             for k in ("x", "pt", "labels", "g_focal", "g_distill"))
    g, p = got["groups"], K.ClsLossParams(*got["params"])
    sums, ref = K.cls_losses_fwd(x, pt, labels, g, p), cls_losses_fwd_plain(x, pt, labels, g, p)
    dx, dref = (K.cls_losses_bwd(x, pt, labels, gf, gd, p),
                cls_losses_bwd_plain(x, pt, labels, gf, gd, p))
    torch.cuda.synchronize()
    rel = float(((sums - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    drel = float((dx - dref).abs().max() / dref.abs().max())
    if not rel <= 1e-5 or not drel <= 1e-5:
        raise AssertionError(f"cls losses at the band's P3: sums rel err {rel:.3e}, dx err "
                             f"{drel:.3e} of max|dx| (limits 1e-5)")
    flush = _l2_flush(torch)
    ms = [_median_ms(torch, fn, n, warmup, flush) for fn, n in (
        (lambda: K.cls_losses_fwd(x, pt, labels, g, p), iters * 5),
        (lambda: K.cls_losses_bwd(x, pt, labels, gf, gd, p), iters * 5),
        (lambda: cls_losses_fwd_plain(x, pt, labels, g, p), iters),
        (lambda: cls_losses_bwd_plain(x, pt, labels, gf, gd, p), iters))]
    del flush
    b_fwd, b_bwd = _cls_bounds(x.shape[0], x.shape[1], g)
    said = (f"the cls-loss kernels at {where} ({x.shape[0]} rows x {x.shape[1]}, G={g} "
            f"images): sums {rel:.2e} relative, dx {drel:.2e} of max|dx|; fwd {ms[0]:.4f} ms "
            f"(plain {ms[2]:.4f}, bound {b_fwd['bound_ms']:.4f}), bwd {ms[1]:.4f} ms (plain "
            f"{ms[3]:.4f}, bound {b_bwd['bound_ms']:.4f}), CUDA-event medians after an L2 flush")
    return ({"max_abs_err": float((sums - ref).abs().max()), "ms": ms[0], "plain_ms": ms[2],
             **b_fwd, "rows": x.shape[0]},
            {"max_abs_err": float((dx - dref).abs().max()), "ms": ms[1], "plain_ms": ms[3],
             **b_bwd, "rows": x.shape[0]}, said)


def phase_spatial_joint_step(torch, seed, iters, warmup, gpu):
    """[spatial_joint_step]: the R-50 <- R-101 joint step at full width, bs 4
    (G = 2) on 640x1024, on a 2 x 2 mesh (sad_tpu's dryrun phase-2 layout:
    every loss group spans two ranks), against one process (a world of 1
    over NCCL) from the same seeded state and batch: DDP_STEPS steps at
    float32 with TF32 and cuDNN off, metrics within SPATIAL_TOL relative and
    every parameter tensor within SPATIAL_TOL relative L2 or, beyond it,
    its error against one process's float64-compute run within
    SPATIAL_F64_FACTOR times the worst of one process's float32 step there;
    parameters and momenta bit-equal across the four ranks, one cls-loss
    forward and backward a level a step on each rank at its band's rows;
    SPATIAL_TIMED timed steps with cuDNN. Then the same compared steps at
    float64 compute against one process's, within SPATIAL_TOL. Then the
    cls-loss kernels against their twin at the first rank's band of P3
    (cls_losses_fwd@band_p3, _bwd@band_p3)."""
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.parallel.mesh import row_band
    from sad_tpu_torch.tools import profile_ddp, profile_spatial, profile_train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    backend, local, note = profile_ddp.card_layout(4)
    kw = {"seed": seed, "n_groups": 2, "device": "cuda", "opts": ["COMPUTE_DTYPE", "float32"]}
    kw64 = {**kw, "opts": ["COMPUTE_DTYPE", "float64"]}
    build, lr = profile_train.seeded_train_step, profile_train.BENCH_LR
    one_jobs = [("one", {"build": build, "build_kwargs": kw, "steps": DDP_STEPS, "lr": lr,
                         "iters": SPATIAL_TIMED}),
                ("one", {"build": build, "build_kwargs": kw64, "steps": DDP_STEPS, "lr": lr})]
    one, one64 = spawn(profile_spatial.rank_jobs, 1, (one_jobs,), device="cuda", local_ranks=[0],
                       timeout_s=DDP_TIMEOUT_S)[0]
    jobs = [("steps", {"build": build, "build_kwargs": kw, "n_data": 2, "n_model": 2,
                       "steps": DDP_STEPS, "lr": lr, "iters": SPATIAL_TIMED, "capture": True}),
            ("steps", {"build": build, "build_kwargs": kw64, "n_data": 2, "n_model": 2,
                       "steps": DDP_STEPS, "lr": lr})]
    out = spawn(profile_spatial.rank_jobs, 4, (jobs,), device="cuda", backend=backend,
                local_ranks=local, timeout_s=DDP_TIMEOUT_S)
    ranks, ranks64 = [r[0] for r in out], [r[1] for r in out]
    res, res64 = profile_ddp.compare(one, ranks), profile_ddp.compare(one64, ranks64)
    f64 = profile_spatial.against_float64(one, ranks, one64, SPATIAL_TOL)
    beyond, (one_err, one_key) = f64["beyond"], f64["one_worst"]
    bad = []
    for tag, r in (("float32", res), ("float64", res64)):
        if not r["metric_rel"] <= SPATIAL_TOL:
            bad.append(f"{tag} metric {r['metric_key']} {r['metric_rel']:.3e}")
        if r["unequal_across_ranks"]:
            bad.append(f"{tag} not bit-equal across the ranks: {r['unequal_across_ranks'][:3]}")
    if not res64["param_rel_l2"] <= SPATIAL_TOL:
        bad.append(f"float64 parameter {res64['param_key']} {res64['param_rel_l2']:.3e}")
    for k, e in beyond.items():
        if not e["mesh_vs_f64"] <= SPATIAL_F64_FACTOR * one_err:
            bad.append(f"float32 parameter {k} {e['mesh_vs_one']:.3e} from one process's and "
                       f"{e['mesh_vs_f64']:.3e} from the float64 run, where one process's "
                       f"float32 step is at most {one_err:.3e} ({one_key}; limit "
                       f"{SPATIAL_F64_FACTOR:g}x)")
    for r in ranks:
        bands = [row_band(h, 2, r["rank"] % 2) for h, _ in LEVEL_HW.values()]
        rows = sorted(r["n_images"] * (b - a) * w * 9
                      for (a, b), (_, w) in zip(bands, LEVEL_HW.values()) if b > a)
        want = [(x, DDP_STEPS) for x in rows]
        la = r["launches"]
        got = (sorted(la["cls_fwd_by_rows"].items()), sorted(la["cls_bwd_by_rows"].items()),
               la["nms"], la["roi_align_fwd"])
        if got != (want, want, 0, 0):
            bad.append(f"rank {r['rank']} launches {got}, want {(want, want, 0, 0)}")
    if bad:
        raise AssertionError("spatial_joint_step: " + "; ".join(bad))
    fwd, bwd, said = _band_cls_rows(torch, ranks[0]["band_p3"], iters, warmup)
    p3 = ranks[0]["n_images"] * (LEVEL_HW[3][0] // 2) * LEVEL_HW[3][1] * 9
    if fwd["rows"] != p3:
        raise AssertionError(f"spatial_joint_step: the band's P3 has {fwd['rows']} rows, want {p3}")
    med = statistics.median
    held = "; ".join(f"{k} {e['mesh_vs_one']:.3e} from one process's, against the float64 run "
                     f"{e['mesh_vs_f64']:.3e} (one process {e['one_vs_f64']:.3e})"
                     for k, e in sorted(beyond.items(),
                                        key=lambda kv: -kv[1]["mesh_vs_one"])[:6])
    _phase("spatial_joint_step", f"R-50 <- R-101 at float32, bs 4 (G = 2) on 640x1024 over a "
           f"2 x 2 mesh ({note}; halo transport {ranks[0]['transport']}; every loss group over "
           f"two ranks, bands {[r['band_rows'] for r in ranks[:2]]}) against one process (NCCL, "
           f"world 1), TF32 and cuDNN off, {DDP_STEPS} steps: worst metric {res['metric_key']} "
           f"{res['metric_rel']:.3e} relative, worst parameter {res['param_key']} "
           f"{res['param_rel_l2']:.3e} relative L2 (momentum {res['velocity_key']} "
           f"{res['velocity_rel_l2']:.3e}); against one process's step at float64 compute the "
           f"worst parameter of one process's float32 step is {one_key} {one_err:.3e} relative "
           f"L2, of the mesh's {f64['mesh_worst'][1]} {f64['mesh_worst'][0]:.3e}; "
           f"{len(beyond)} parameter tensors beyond {SPATIAL_TOL:g} from one process's, each "
           f"held there to {SPATIAL_F64_FACTOR:g}x one process's worst"
           f"{': ' + held if held else ''}; at float64 compute worst "
           f"metric {res64['metric_key']} {res64['metric_rel']:.3e}, parameter "
           f"{res64['param_key']} {res64['param_rel_l2']:.3e}; parameters and momenta bit-equal "
           f"across the 4 ranks at both; "
           f"one cls-loss forward and backward a level a step on each rank at its band's rows; "
           f"{SPATIAL_TIMED} timed steps with cuDNN, medians by rank: step ms "
           f"{_fmt([med(r['step_ms']) for r in ranks])} against one process's "
           f"{med(one['step_ms']):.2f}, gradient all-reduce ms "
           f"{_fmt([med(r['reduce_ms']) for r in ranks])} for {one['grad_bytes'] / 1e6:.1f} MB; "
           f"{SPATIAL_TIMED} more with each exchange timed (a device sync around each): step ms "
           f"{_fmt([med(r['instrumented_step_ms']) for r in ranks])}, halo ms "
           f"{_fmt([med(r['halo_ms']) for r in ranks])} and bytes a step "
           f"{[int(r['halo_bytes_per_step']) for r in ranks]}"
           f"; peak GiB of the timed steps {_fmt([r['timed_peak_gib'] for r in ranks], 3)} against "
           f"one process's {one['timed_peak_gib']:.3f} (of the compared steps "
           f"{_fmt([r['peak_gib'] for r in ranks], 3)} against {one['peak_gib']:.3f}); {said}; {gpu}",
           time.perf_counter() - t0)
    # every rank's band of P3 holds 40 of its 80 rows: the launches at that shape
    return {"launches": [(r["launches"]["cls_fwd_by_rows"].get(p3, 0),
                          r["launches"]["cls_bwd_by_rows"].get(p3, 0)) for r in ranks],
            "fwd": fwd, "bwd": bwd, "one": one}


# --------------------------------------------------------------------------- #
# sad_tpu's multislice mesh ('dcn') and R-CNN loss groups that span ranks
# --------------------------------------------------------------------------- #

# timed steps of [multislice_joint_step], and as many instrumented; as [spatial_joint_step]'s,
# whose one-process run of the same seed it reuses
MULTISLICE_TIMED = SPATIAL_TIMED
SPAN_LOOP_ITERS, SPAN_SNAP = 4, 2  # [span_train_loop]: iterations, the snapshot's


def _levels_said(r):
    """A rank's medians of its instrumented steps: the two levels of the
    gradient sum, the flat all-reduce beside it, the count all-reduce."""
    from sad_tpu_torch.tools.profile_ddp import reduction_numbers

    n = reduction_numbers(r)
    return (f"node {n['node_ms']:.2f} ms / {n['node_bytes'] / 1e6:.1f} MB, cross-node "
            f"{n['cross_ms']:.2f} ms / {n['cross_bytes'] / 1e6:.1f} MB, flat "
            f"{n['flat_ms']:.2f} ms / {n['flat_bytes'] / 1e6:.1f} MB, counts "
            f"{n['counts_ms']:.3f} ms / {n['counts_bytes']} B"), n


def phase_multislice_joint_step(torch, seed, iters, warmup, gpu, one=None):
    """[multislice_joint_step]: the R-50 <- R-101 joint step at full width,
    bs 4 (G = 2) on 640x1024, over 4 ranks as 2 nodes x 2 (spawn(nodes=2):
    torchrun's environment; create_multislice_mesh(): one image a rank, each
    loss group over a node's two ranks, the gradients summed in two levels),
    against one process (a world of 1 over NCCL) from the same seeded state
    and batch: DDP_STEPS steps at float32 with TF32 and cuDNN off in every
    rank, metrics within SPATIAL_TOL relative and every parameter tensor
    within SPATIAL_TOL relative L2 or, beyond it, its error against one
    process's float64-compute run (made only then) within SPATIAL_F64_FACTOR
    times the worst of one process's float32 step there; parameters and momenta bit-equal
    across the four ranks after every step; one cls-loss forward and
    backward a level a step on each rank at its image's rows;
    MULTISLICE_TIMED timed steps with cuDNN, then as many instrumented (each
    level of the sum, a flat all-reduce of the same gradients, the count
    all-reduce, each between device syncs). Then the cls-loss kernels
    against their twin at the first rank's P3 (cls_losses_fwd@multislice_p3,
    _bwd@multislice_p3). ``one``: that one process's run when the caller has
    it ([spatial_joint_step]'s, of the same seed and batch)."""
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools import profile_ddp, profile_spatial, profile_train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    backend, local, note = profile_ddp.card_layout(4)
    kw = {"seed": seed, "n_groups": 2, "device": "cuda", "opts": ["COMPUTE_DTYPE", "float32"]}
    build, lr = profile_train.seeded_train_step, profile_train.BENCH_LR

    def one_process(build_kwargs, iters_):
        job = ("one", {"build": build, "build_kwargs": build_kwargs, "steps": DDP_STEPS,
                       "lr": lr, "iters": iters_})
        return spawn(profile_spatial.rank_jobs, 1, ([job],), device="cuda", local_ranks=[0],
                     timeout_s=DDP_TIMEOUT_S)[0][0]

    one = one or one_process(kw, MULTISLICE_TIMED)
    jobs = [("steps", {"build": build, "build_kwargs": kw, "n_data": 4, "n_model": 1,
                       "n_slices": 2, "steps": DDP_STEPS, "lr": lr, "iters": MULTISLICE_TIMED,
                       "capture": True})]
    ranks = [r[0] for r in spawn(profile_spatial.rank_jobs, 4, (jobs,), device="cuda",
                                 backend=backend, local_ranks=local, nodes=2,
                                 timeout_s=DDP_TIMEOUT_S)]
    res = profile_ddp.compare(one, ranks)
    beyond, one_err, one_key, f64 = {}, None, None, None
    if res["param_rel_l2"] > SPATIAL_TOL:
        # a tensor beyond the tolerance is held to one process's float64-compute step
        one64 = one_process({**kw, "opts": ["COMPUTE_DTYPE", "float64"]}, 0)
        f64 = profile_spatial.against_float64(one, ranks, one64, SPATIAL_TOL)
        beyond, (one_err, one_key) = f64["beyond"], f64["one_worst"]
    bad = []
    if not res["metric_rel"] <= SPATIAL_TOL:
        bad.append(f"metric {res['metric_key']} {res['metric_rel']:.3e}")
    if res["unequal_across_ranks"]:
        bad.append(f"not bit-equal across the ranks: {res['unequal_across_ranks'][:3]}")
    for k, e in beyond.items():
        if not e["mesh_vs_f64"] <= SPATIAL_F64_FACTOR * one_err:
            bad.append(f"parameter {k} {e['mesh_vs_one']:.3e} from one process's and "
                       f"{e['mesh_vs_f64']:.3e} from the float64 run, where one process's "
                       f"float32 step is at most {one_err:.3e} ({one_key}; limit "
                       f"{SPATIAL_F64_FACTOR:g}x)")
    transport = f"{'nccl' if backend == 'nccl' else 'gloo'} two-level"
    rows = sorted(h * w * 9 for h, w in LEVEL_HW.values())
    want = [(x, DDP_STEPS) for x in rows]
    for r in ranks:
        la = r["launches"]
        got = (sorted(la["cls_fwd_by_rows"].items()), sorted(la["cls_bwd_by_rows"].items()),
               la["nms"], la["roi_align_fwd"])
        if got != (want, want, 0, 0):
            bad.append(f"rank {r['rank']} launches {got}, want {(want, want, 0, 0)}")
        if (r["n_images"], r["reduction_transport"]) != (1, transport):
            bad.append(f"rank {r['rank']}: {r['n_images']} images, {r['reduction_transport']}")
    if bad:
        raise AssertionError("multislice_joint_step: " + "; ".join(bad))
    fwd, bwd, said = _band_cls_rows(torch, ranks[0]["band_p3"], iters, warmup,
                                    "the first rank's P3")
    p3 = LEVEL_HW[3][0] * LEVEL_HW[3][1] * 9
    if fwd["rows"] != p3:
        raise AssertionError(f"multislice_joint_step: P3 has {fwd['rows']} rows, want {p3}")
    med = statistics.median
    levels = [_levels_said(r) for r in ranks]
    held = "; ".join(f"{k} {e['mesh_vs_one']:.3e} from one process's, against the float64 run "
                     f"{e['mesh_vs_f64']:.3e} (one process {e['one_vs_f64']:.3e})"
                     for k, e in sorted(beyond.items(),
                                        key=lambda kv: -kv[1]["mesh_vs_one"])[:6])
    _phase("multislice_joint_step", f"R-50 <- R-101 at float32, bs 4 (G = 2) on 640x1024 over "
           f"4 ranks as 2 nodes x 2 ({note}; torchrun's environment, create_multislice_mesh(): "
           f"slices {[r['slice'] for r in ranks]}, one image a rank, each loss group over a "
           f"node's two ranks; gradient sum {transport}) against one process (NCCL, world 1), "
           f"TF32 and cuDNN off, {DDP_STEPS} steps: worst metric {res['metric_key']} "
           f"{res['metric_rel']:.3e} relative, worst parameter {res['param_key']} "
           f"{res['param_rel_l2']:.3e} relative L2 (momentum {res['velocity_key']} "
           f"{res['velocity_rel_l2']:.3e}); "
           + (f"{len(beyond)} parameter tensors beyond {SPATIAL_TOL:g} from one process's, each "
              f"held to {SPATIAL_F64_FACTOR:g}x one process's worst error against its "
              f"float64-compute step ({one_key} {one_err:.3e}; the mesh's worst there "
              f"{f64['mesh_worst'][1]} {f64['mesh_worst'][0]:.3e}){': ' + held if held else ''}; "
              if f64 else f"every parameter tensor within {SPATIAL_TOL:g} of one process's; ")
           + f"parameters and momenta bit-equal across the 4 ranks after every step; one cls-loss "
           f"forward and backward a level a step on each rank at its image's rows; "
           f"{MULTISLICE_TIMED} timed steps with cuDNN, medians by rank: step ms "
           f"{_fmt([med(r['step_ms']) for r in ranks])} against one process's bs-4 "
           f"{med(one['step_ms']):.2f}, gradient sum ms {_fmt([med(r['reduce_ms']) for r in ranks])}"
           f" for {one['grad_bytes'] / 1e6:.1f} MB; {MULTISLICE_TIMED} instrumented steps (a "
           f"device sync around each collective), by rank: "
           + "; ".join(f"rank {r['rank']} {s_}" for r, (s_, _) in zip(ranks, levels))
           + f"; {said}; {gpu}", time.perf_counter() - t0)
    return {"launches": [(r["launches"]["cls_fwd_by_rows"].get(p3, 0),
                          r["launches"]["cls_bwd_by_rows"].get(p3, 0)) for r in ranks],
            "fwd": fwd, "bwd": bwd, "reduction": [n for _, n in levels],
            "step_ms": [med(r["step_ms"]) for r in ranks], "one_step_ms": med(one["step_ms"])}


def _span_kernel_rows(torch, cap, iters, warmup):
    """The NMS and RoIAlign kernels against their twins on a rank's own
    first-step inputs (``profile_ddp.kernel_inputs``): the RPN's NMS exactly,
    the box RoIAlign forward bit-equal, its backward at float32 within 1e-5 *
    max|ref|; each timed by CUDA events after an L2 flush, with its bound."""
    from sad_tpu_torch.ops import nms, nms_kernel, roi_align_kernel
    from sad_tpu_torch.ops.roi_align import (
        multilevel_roi_align_bwd_plain, multilevel_roi_align_plain,
    )
    from sad_tpu_torch.tools.profile_roi_align import roi_align_bound

    def cuda(x):
        return x.cuda() if torch.is_tensor(x) else [cuda(y) for y in x] \
            if isinstance(x, list) else x

    flush = _l2_flush(torch)
    boxes, scores, thr, max_out = cuda(cap["nms"])
    ik, vk = nms_kernel.nms_cuda(boxes, scores, thr, max_out)
    ip, vp = nms.nms_multi_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip) or not torch.equal(vk, vp):
        raise AssertionError(f"span_train_loop: NMS kernel != plain on the rank's RPN "
                             f"({int((ik != ip).sum())} idx differ)")
    nms_row = {"max_abs_err": float((ik - ip).abs().max()), **_nms_bound(*scores.shape, max_out, vk),
               "ms": _median_ms(torch, lambda: nms_kernel.nms_cuda(boxes, scores, thr, max_out),
                                iters * 5, warmup, flush),
               "plain_ms": _median_ms(torch, lambda: nms.nms_multi_plain(boxes, scores, thr,
                                                                          max_out),
                                      max(iters // 5, 1), 1, flush)}
    feats, lvl_min, rois, levels, valid, res, sr = cuda(cap["roi_fwd_7"])
    fmap = {lvl_min + i: f for i, f in enumerate(feats)}
    err, _ = _roi_align_check(torch, "span box", fmap, rois, levels, valid, res, sr)
    fwd_row = {"max_abs_err": err, **roi_align_bound(fmap, rois, levels, valid, res, sr)[0],
               "ms": _median_ms(torch, lambda: roi_align_kernel.roi_align_fwd_cuda(
                   feats, lvl_min, rois, levels, valid, res, sr), iters * 2, warmup, flush),
               "plain_ms": _median_ms(torch, lambda: multilevel_roi_align_plain(
                   fmap, rois, levels, valid, res, sr), max(iters // 5, 1), 1, flush)}
    g, level_hw, b_lvl, batch, b_rois, b_levels, b_valid, b_sr = cuda(cap["roi_bwd_7"])
    g = g.float().contiguous()
    hw = {b_lvl + i: tuple(x) for i, x in enumerate(level_hw)}
    got = roi_align_kernel.roi_align_bwd_cuda(g, level_hw, b_lvl, batch, b_rois, b_levels,
                                              b_valid, b_sr)
    ref = multilevel_roi_align_bwd_plain(g, hw, batch, b_rois, b_levels, b_valid, b_sr)
    torch.cuda.synchronize()
    ref_max = max(float(ref[l].abs().max()) for l in hw)
    bwd_err = max(float((got[i] - ref[l]).abs().max()) for i, l in enumerate(sorted(hw)))
    if not bwd_err <= 1e-5 * ref_max:
        raise AssertionError(f"span_train_loop: RoIAlign backward {bwd_err:.3e} from the plain "
                             f"scatter's, limit 1e-5 * {ref_max:.3e}")
    bwd_row = {"max_abs_err": bwd_err,
               **_roi_align_bwd_bound(list(hw.values()), batch, g.shape[-1], 4, g.shape[0],
                                      g.shape[1], b_sr)[0],
               "ms": _median_ms(torch, lambda: roi_align_kernel.roi_align_bwd_cuda(
                   g, level_hw, b_lvl, batch, b_rois, b_levels, b_valid, b_sr),
                   iters * 2, warmup, flush),
               "plain_ms": _median_ms(torch, lambda: multilevel_roi_align_bwd_plain(
                   g, hw, batch, b_rois, b_levels, b_valid, b_sr), max(iters // 5, 1), 1, flush)}
    del flush
    said = (f"on the first rank's own inputs, CUDA-event medians after an L2 flush: NMS "
            f"{scores.shape[0]} x {scores.shape[1]} -> {max_out} (thr {thr}) equal to the plain "
            f"NMS, {nms_row['ms']:.4f} ms (plain {nms_row['plain_ms']:.4f}, bound "
            f"{nms_row['bound_ms']:.4f}); RoIAlign forward R={rois.shape[0]} res {res} C="
            f"{feats[0].shape[-1]} ({feats[0].dtype}) bit-equal, {fwd_row['ms']:.4f} ms (plain "
            f"{fwd_row['plain_ms']:.4f}, bound {fwd_row['bound_ms']:.4f}); backward at float32 "
            f"{bwd_err:.3e} of max {ref_max:.3e}, {bwd_row['ms']:.4f} ms (plain "
            f"{bwd_row['plain_ms']:.4f}, bound {bwd_row['bound_ms']:.4f})")
    return nms_row, fwd_row, bwd_row, said


def _one_process_first_counts(torch, argv):
    """One process's first iteration of train_net's R-CNN step on ``argv``'s
    configuration, made as train_model makes it (the model from RNG_SEED, the
    loader's first batch, the sampler seeded for iteration 0), forward only,
    on PyTorch's own convolutions: its per-group counts (G,) by name."""
    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.tools.train_net import parse_args
    from sad_tpu_torch.train import batch_to_torch, make_rcnn_train_step
    from sad_tpu_torch.train.train_loop import _make_loader, rcnn_step_seed

    args = parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.opts)
    dev = torch.device("cuda")
    model = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(cfg.RNG_SEED))
    step = make_rcnn_train_step(cfg, model, generator=torch.Generator(device=dev).manual_seed(
        rcnn_step_seed(cfg, 0)))
    loader = _make_loader(cfg, None, False, True, 0)
    try:
        batch = loader.get_next_batch()
    finally:
        loader.shutdown()
    torch.backends.cudnn.enabled = False
    try:
        with torch.no_grad():
            step.losses(batch_to_torch(batch, dev))
    finally:
        torch.backends.cudnn.enabled = True
    counts = {k: v.cpu().numpy() for k, v in step.counts.items()}
    del step, model
    return counts


def phase_span_train_loop(torch, data_root, iters, warmup, gpu):
    """[span_train_loop]: train_net with the Mask R-CNN R-50-FPN YAML over
    smoke_lab on 4 ranks as 2 nodes x 2 (torchrun's environment through
    spawn(nodes=2)), NUM_GPUS = 2, TRAIN.IMS_PER_BATCH = 2: 4 images, one a
    rank, each R-CNN loss group over a node's two ranks (the loop builds
    create_multislice_mesh()). SPAN_LOOP_ITERS iterations with a snapshot
    after iteration SPAN_SNAP, at float32 with TF32 off on PyTorch's own
    convolutions (an image's forward then does not depend on the batch
    beside it, so the counts can be held exactly; deterministic besides);
    then, in the same world, a 4-rank run resumed in a fresh directory from
    that snapshot; and meanwhile in this process one process's first
    iteration
    (``_one_process_first_counts``). Only rank 0's files; the ranks
    bit-equal; the resumed run bit-equal to the uninterrupted one; each
    rank's launches NMS 1, RoIAlign forward 3 and backward 2 a step; the
    first step's per-group counts equal to one process's exactly. Then the
    kernels on the first rank's own inputs (``_span_kernel_rows``)."""
    import tempfile

    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools import profile_ddp, profile_spatial

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    backend, local, note = profile_ddp.card_layout(4)
    _smoke_coco(data_root, 0)
    tmp = tempfile.mkdtemp(prefix="span_train_loop_", dir=data_root)
    regs = [_spec("smoke_lab")]
    n_iter, snap = SPAN_LOOP_ITERS, SPAN_SNAP

    def argv(out_dir, max_iter):
        # a snapshot every (SNAPSHOT_ITERS / NUM_GPUS) = SPAN_SNAP + 1 iterations
        return ["--cfg", os.path.join(REPO, MASK_CFG), "--skip-test"] + _loop_opts(
            out_dir, "NUM_GPUS", "2", "TRAIN.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER",
            str(max_iter), "TRAIN.SNAPSHOT_ITERS", str(2 * (snap + 1)),
            "DATA_LOADER.NUM_PROCESSES", "0", "DATA_LOADER.NUM_THREADS", "2",
            "COMPUTE_DTYPE", "float32")

    def cli(out_dir, **kw):
        return ("cli", {"tool": "train_net", "argv": argv(out_dir, n_iter), "datasets": regs,
                        "deterministic": True, "cudnn": False, **kw})

    whole_dir, resumed_dir = os.path.join(tmp, "whole"), os.path.join(tmp, "resumed")
    # one world: the uninterrupted run, then (rank 0 having copied its snapshot into a fresh
    # directory) the resumed one; meanwhile this process runs one process's first iteration
    jobs = [cli(whole_dir, capture=True),
            cli(resumed_dir, seed_files=[(os.path.join(_run_dir(whole_dir),
                                                       f"model_iter{snap}.pkl"),
                                          _run_dir(resumed_dir))])]
    with ThreadPoolExecutor(1) as pool:
        ts = time.perf_counter()
        world_f = pool.submit(spawn, profile_spatial.rank_jobs, 4, (jobs,), device="cuda",
                              backend=backend, local_ranks=local, nodes=2,
                              timeout_s=DDP_TIMEOUT_S, log_prefix=os.path.join(tmp, "ranks"))
        counts = _one_process_first_counts(torch, argv(os.path.join(tmp, "one"), 1))
        one_s = time.perf_counter() - ts
        out = world_f.result()
        world_s = time.perf_counter() - ts
    whole, resumed = [r[0] for r in out], [r[1] for r in out]
    lines = _check_run_files("span_train_loop", whole_dir, (snap,))
    if [ln["iter"] for ln in lines] != [0, n_iter - 1] or "loss_mask" not in lines[-1]:
        raise AssertionError(f"span_train_loop: stats.jsonl {lines}")
    bad = []
    for r in whole + resumed:
        la, steps = r["launches"], r["iters"]
        got = (la["nms"], la["roi_align_fwd"], la["roi_align_bwd"], la["cls_fwd"])
        if got != (steps, 3 * steps, 2 * steps, 0):
            bad.append(f"rank {r['rank']} launches {got} in {steps} steps")
    if [(r["start_iter"], r["iters"]) for r in resumed] != [(snap + 1, n_iter - snap - 1)] * 4:
        bad.append(f"resumed at {[(r['start_iter'], r['iters']) for r in resumed]}")
    for group in (whole, resumed):
        for r in group[1:]:
            for tree in ("params", "velocity"):
                if any(not np.array_equal(v, group[0][tree][k]) for k, v in r[tree].items()):
                    bad.append(f"rank {r['rank']} {tree} differ from rank 0's")
    for a, b in zip(whole, resumed):
        for tree in ("params", "velocity"):
            differ = [k for k, v in a[tree].items() if not np.array_equal(v, b[tree][k])]
            if differ:
                bad.append(f"rank {a['rank']}: resumed {tree} differ, e.g. {differ[:2]}")
    if sorted(counts) != ["box", "live", "mask"]:
        bad.append(f"one process's counts {sorted(counts)}")
    for r in whole:
        if sorted(r["first_counts"]) != sorted(counts) or any(
                not np.array_equal(r["first_counts"][k], v) for k, v in counts.items()):
            bad.append(f"rank {r['rank']} first-step counts {r['first_counts']} != one "
                       f"process's {counts}")
    if bad:
        raise AssertionError("span_train_loop: " + "; ".join(bad))
    nms_row, fwd_row, bwd_row, said = _span_kernel_rows(torch, whole[0]["captured"], iters, warmup)
    iter_ms = [statistics.median(r["iter_ms"][1:]) for r in whole]
    per_step = {k[:-6]: v / n_iter for k, v in whole[0]["reduction_bytes"].items() if v}
    _phase("span_train_loop", f"{note}, as 2 nodes x 2 (torchrun's environment); train_net "
           f"{MASK_CFG} over smoke_lab, NUM_GPUS = 2, bs 4 (one image a rank, each loss group "
           f"over a node's two ranks), {n_iter} iterations at float32 on PyTorch's own "
           f"convolutions (TF32 and cuDNN off): files "
           f"{sorted(os.listdir(_run_dir(os.path.join(tmp, 'whole'))))} (rank 0's only; loss "
           f"{lines[0]['loss']:.4f} -> {lines[-1]['loss']:.4f}, loss_mask "
           f"{lines[-1]['loss_mask']:.4f}), the ranks' parameters and momenta bit-equal, a "
           f"4-rank run resumed from model_iter{snap}.pkl in a fresh directory bit-identical; "
           f"launches on every rank NMS 1, RoIAlign forward 3 and backward 2 a step; the first "
           f"step's global per-group counts (box {counts['box'].tolist()}, live "
           f"{counts['live'].tolist()}, mask {counts['mask'].tolist()}) equal to one process's "
           f"exactly on every rank; bytes a step on the first rank: "
           + ", ".join(f"{k} {v / 1e6:.1f} MB" if v > 1e4 else f"{k} {v:.0f} B"
                       for k, v in per_step.items())
           + f"; iteration ms by rank {_fmt(iter_ms)} (medians after the "
           f"first); the world (start, the run, the resumed run) {world_s:.1f} s, one "
           f"process's first iteration beside it {one_s:.1f} s (loader threads, no worker "
           f"processes); {said}; "
           f"{gpu}", time.perf_counter() - t0)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": [r["launches"] for r in whole], "nms": nms_row, "fwd": fwd_row,
            "bwd": bwd_row, "bytes_per_step": per_step}


def _spec(name):
    from sad_tpu_torch.config import get_dataset_spec

    spec = get_dataset_spec(name)
    return (name, spec.image_directory, spec.annotation_file, spec.is_pseudo_labeled)


def _match_detections(what, got, want, score_tol=1e-5, box_tol=1e-3):
    """The W-rank detections against one process's: the same images in the
    same order with as many detections each, and within an image every
    detection matched to one of the same category, score within score_tol
    and box within box_tol px (scores that tie within the tolerance may sit
    in another order: top-k ties are the implementation's). Returns the
    worst differences and how many matched at another place."""
    if not want or [d["image_id"] for d in got] != [d["image_id"] for d in want]:
        raise AssertionError(f"ddp_test_net: {what}: the images of the {len(got)} merged "
                             f"detections are not the one process's {len(want)} in its order")
    by_image = {}
    for i, (x, y) in enumerate(zip(got, want)):
        by_image.setdefault(x["image_id"], ([], []))
        by_image[x["image_id"]][0].append(x)
        by_image[x["image_id"]][1].append(y)
    worst_s = worst_b = 0.0
    moved = 0
    for image, (xs, ys) in by_image.items():
        free = list(range(len(ys)))
        for i, x in enumerate(xs):
            for j in free:
                y = ys[j]
                ds, db = abs(x["score"] - y["score"]), float(
                    np.abs(np.subtract(x["bbox"], y["bbox"])).max())
                if x["category_id"] == y["category_id"] and ds <= score_tol and db <= box_tol:
                    worst_s, worst_b = max(worst_s, ds), max(worst_b, db)
                    moved += j != i
                    free.remove(j)
                    break
            else:
                near = min(((abs(x["score"] - ys[j]["score"]), float(np.abs(np.subtract(
                    x["bbox"], ys[j]["bbox"])).max())) for j in free
                    if ys[j]["category_id"] == x["category_id"]), default=None)
                raise AssertionError(f"ddp_test_net: {what}: image {image}'s detection {x} has "
                                     f"no match among the one process's (nearest of its "
                                     f"category: score, box differences {near})")
    return {"score": worst_s, "bbox": worst_b, "moved": moved}


def phase_ddp_test_net(torch, seed, data_root, state, gpu):
    """test_net --multi-gpu-testing over the W ranks against one process on
    the smoke's val split (both orientations), float32 with TF32 off in
    every process (with bf16 compute and TF32 left on in the ranks, one
    detection of one image found no match: PERF.md §6): the R-50
    student's bbox_results.json and results.json, and --pseudo-out
    (top 10 an image, score threshold 0) whose pseudo.json [ddp_train_loop]
    trains on. The
    merged detections must be the one process's in its order (image and
    category equal, scores within 1e-5, boxes within 1e-3 px); each rank's
    NMS launches one a batch of its shard."""
    import tempfile

    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.data.dataset import CocoDataset
    from sad_tpu_torch.models import create_model
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools import profile_spatial, test_net
    from sad_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    world, backend, local, note = _ddp_world(torch)
    _smoke_coco(data_root, 0, ("smoke_val",))
    tmp = tempfile.mkdtemp(prefix="ddp_test_net_", dir=data_root)
    model = create_model(load_cfg(os.path.join(REPO, STUDENT_CFG)), "cuda",
                         torch.Generator(device="cuda").manual_seed(seed))
    pkl = os.path.join(tmp, "student.pkl")
    save_checkpoint(pkl, model)
    del model
    # (flags, config options) of the two runs
    runs = {"eval": ([], []),
            "pseudo": (["--pseudo-out", "{}/pseudo.json", "--pseudo-score-thresh", "0.0"],
                       ["TEST.DETECTIONS_PER_IM", "10"])}
    out, argvs, timing, one_launches = {}, {}, {}, {}
    for key, (flags, opts) in runs.items():
        for n in (1, world):
            d = os.path.join(tmp, f"{key}{n}")
            argvs[(key, n)] = (
                ["--cfg", os.path.join(REPO, STUDENT_CFG), "--weights", pkl]
                + [a.format(d) for a in flags] + (["--multi-gpu-testing"] if n > 1 else [])
                + ["TEST.DATASETS", "('smoke_val',)", "COMPUTE_DTYPE", "float32", *opts,
                   "OUTPUT_DIR", d])
            out[(key, n)] = d
    for key in runs:
        # the one process runs here: its counts set to 0 just before, read just after
        ts = time.perf_counter()
        _reset_counts()
        test_net.main(argvs[(key, 1)])
        one_launches[key] = _all_counts()
        timing[key] = time.perf_counter() - ts
    # one world of W ranks runs both
    jobs = [("cli", {"tool": "test_net", "argv": argvs[(key, world)],
                     "datasets": [_spec("smoke_val")]}) for key in runs]
    ts = time.perf_counter()
    ranks = spawn(profile_spatial.rank_jobs, world, (jobs,), device="cuda", backend=backend,
                  local_ranks=local, timeout_s=DDP_TIMEOUT_S, log_prefix=os.path.join(tmp, "ranks"))
    world_s = time.perf_counter() - ts
    launches = {key: [r[i]["launches"]["nms"] for r in ranks] for i, key in enumerate(runs)}
    sub = os.path.join("test", "smoke_val")
    got = _read_json(os.path.join(out[("eval", world)], sub, "bbox_results.json"))
    want = _read_json(os.path.join(out[("eval", 1)], sub, "bbox_results.json"))
    p_got = _read_json(os.path.join(out[("pseudo", world)], "pseudo.json"))
    p_want = _read_json(os.path.join(out[("pseudo", 1)], "pseudo.json"))
    stats = {what: _match_detections(what, x, y) for what, x, y in (
        ("bbox_results.json", got, want),
        ("pseudo.json", p_got["annotations"], p_want["annotations"]))}
    if [a["id"] for a in p_got["annotations"]] != [a["id"] for a in p_want["annotations"]]:
        raise AssertionError("ddp_test_net: pseudo.json annotation ids differ")
    roidb = CocoDataset("smoke_val").get_roidb(include_gt=False)
    per = -(-len(roidb) // world)
    want_nms = []
    for r in range(world):
        shard = roidb[r * per:(r + 1) * per]
        n_l = sum(e["width"] >= e["height"] for e in shard)
        want_nms.append(-(-n_l // 8) + -(-(len(shard) - n_l) // 8))
    if any(launches[k] != want_nms for k in launches):
        raise AssertionError(f"ddp_test_net: NMS launches by rank {launches}, want {want_nms}")
    n_l = sum(e["width"] >= e["height"] for e in roidb)
    want_one = (-(-n_l // 8) + -(-(len(roidb) - n_l) // 8), 0, 0, 0, 0)
    if any(v != want_one for v in one_launches.values()):
        raise AssertionError(f"ddp_test_net: the one process launched {one_launches}, want "
                             f"{want_one} (NMS one a batch)")
    t_w = _read_json(os.path.join(out[("eval", world)], sub, "timing.json"))
    res_w = _read_json(os.path.join(out[("eval", world)], sub, "results.json"))
    res_1 = _read_json(os.path.join(out[("eval", 1)], sub, "results.json"))
    d_ap = max(abs(res_w[k] - res_1[k]) for k in res_1)
    state["pseudo"] = os.path.join(out[("pseudo", world)], "pseudo.json")
    orient = sum(e["width"] >= e["height"] for e in roidb)
    _phase("ddp_test_net", f"{note}; test_net --multi-gpu-testing over smoke_val ({len(roidb)} "
           f"images, {orient} landscape, {len(roidb) - orient} portrait; shards of {per}): "
           f"{len(got)} merged detections, the images in the one process's order "
           f"({orient} landscape first), each image's matched (worst score "
           f"difference {stats['bbox_results.json']['score']:.2e}, box "
           f"{stats['bbox_results.json']['bbox']:.2e} px; "
           f"{stats['bbox_results.json']['moved']} in another place among score ties), "
           f"results.json within {d_ap:.2e}; --pseudo-out: {len(p_got['annotations'])} "
           f"annotations, ids equal, {stats['pseudo.json']['moved']} moved; NMS launches by rank {launches['eval']} (one a batch of the shard); rank "
           f"walls {_fmt(t_w['rank_wall'])} s for {t_w['rank_images']} images; command seconds "
           f"one process {timing['eval']:.1f} (and {timing['pseudo']:.1f} the --pseudo-out run), "
           f"the world of {world} ranks (start, both runs) {world_s:.1f}; {gpu}",
           time.perf_counter() - t0)
    return {"launches": launches["eval"], "pseudo_launches": launches["pseudo"],
            "one_launches": one_launches["pseudo"]}


def phase_ddp_train_loop(torch, data_root, state, gpu):
    """train_net on W ranks (torchrun's environment, parallel.launch) over
    smoke_lab and the pseudo-labels [ddp_test_net] wrote, bs 8 (G = 4, two
    groups a rank), 8 iterations with a snapshot after iteration 3, under
    deterministic cuDNN; then a W-rank run resumed in a fresh directory from
    model_iter3.pkl. Only rank 0's files, every rank's cls-loss launches at
    its rows, the ranks bit-equal, the resumed run bit-equal to the
    uninterrupted one."""
    import tempfile

    from sad_tpu_torch.config import load_cfg
    from sad_tpu_torch.config.config import cfg_to_yaml
    from sad_tpu_torch.parallel.launch import spawn
    from sad_tpu_torch.tools import profile_spatial
    from sad_tpu_torch.tools.profile_train import BENCH_OPTS

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    world, backend, local, note = _ddp_world(torch)
    _smoke_coco(data_root, 0)
    tmp = tempfile.mkdtemp(prefix="ddp_train_loop_", dir=data_root)
    teacher_yaml = os.path.join(tmp, "teacher.yaml")
    with open(teacher_yaml, "w") as f:
        f.write(cfg_to_yaml(load_cfg(os.path.join(REPO, TEACHER_CFG), BENCH_OPTS)))
    val = _spec("smoke_val")
    regs = [_spec("smoke_lab"), ("smoke_ddp_pl", val[1], state["pseudo"], True)]
    max_iter, snap = 8, 3

    def argv(out_dir):
        return ["--cfg", os.path.join(REPO, STUDENT_CFG), "--teacher_cfg", teacher_yaml,
                "--skip-test"] + _loop_opts(
            out_dir, "DISTILLATION.UNLABEL_DISTILLATION", "True",
            "DISTILLATION.UNLABEL_DATASETS", "('smoke_ddp_pl',)", "SOLVER.MAX_ITER",
            str(max_iter), "DATA_LOADER.NUM_PROCESSES", str(DDP_LOOP_WORKERS))

    whole_dir, resumed_dir = os.path.join(tmp, "whole"), os.path.join(tmp, "resumed")
    # one world: the uninterrupted run, then the resumed one (rank 0 having copied the
    # snapshot into a fresh directory)
    jobs = [("cli", {"tool": "train_net", "argv": argv(whole_dir), "datasets": regs,
                     "deterministic": True}),
            ("cli", {"tool": "train_net", "argv": argv(resumed_dir), "datasets": regs,
                     "deterministic": True, "seed_files": [(os.path.join(
                         _run_dir(whole_dir), f"model_iter{snap}.pkl"), _run_dir(resumed_dir))]})]
    ts = time.perf_counter()
    out = spawn(profile_spatial.rank_jobs, world, (jobs,), device="cuda", backend=backend,
                local_ranks=local, timeout_s=DDP_TIMEOUT_S, log_prefix=os.path.join(tmp, "ranks"))
    world_s = time.perf_counter() - ts
    whole, resumed = [r[0] for r in out], [r[1] for r in out]
    files = sorted(os.listdir(_run_dir(whole_dir)))
    want = ["cfg.yaml", "model_final.pkl", f"model_iter{snap}.pkl", "stats.jsonl"]
    if files != want:
        raise AssertionError(f"ddp_train_loop: run files {files}, want {want} (rank 0's only)")
    lines = _check_run_files("ddp_train_loop", whole_dir, (snap,))
    if [ln["iter"] for ln in lines] != [0, max_iter - 1]:
        raise AssertionError(f"ddp_train_loop: stats.jsonl iterations {[ln['iter'] for ln in lines]}")
    bad = []
    n_rank = 8 // world
    rows = sorted(n_rank * h * w * 9 for h, w in LEVEL_HW.values())
    for r in whole + resumed:
        steps = r["iters"]
        la = r["launches"]
        got = (la["nms"], la["roi_align_fwd"], sorted(la["cls_fwd_by_rows"].items()),
               sorted(la["cls_bwd_by_rows"].items()))
        if got != (0, 0, [(x, steps) for x in rows], [(x, steps) for x in rows]):
            bad.append(f"rank {r['rank']} launches {got} in {steps} steps")
    if [(r["start_iter"], r["iters"]) for r in resumed] != [(snap + 1, max_iter - snap - 1)] * world:
        bad.append(f"resumed at {[(r['start_iter'], r['iters']) for r in resumed]}")
    for group in (whole, resumed):
        for r in group[1:]:
            for tree in ("params", "velocity"):
                if any(not np.array_equal(v, group[0][tree][k]) for k, v in r[tree].items()):
                    bad.append(f"rank {r['rank']} {tree} differ from rank 0's")
    for a, b in zip(whole, resumed):
        for tree in ("params", "velocity"):
            differ = [k for k, v in a[tree].items() if not np.array_equal(v, b[tree][k])]
            if differ:
                bad.append(f"rank {a['rank']}: resumed {tree} differ, e.g. {differ[:2]}")
    if bad:
        raise AssertionError("ddp_train_loop: " + "; ".join(bad))
    iter_ms = [statistics.median(r["iter_ms"][1:]) for r in whole]
    cpu_ms = [statistics.median(r["iter_process_cpu_ms"][1:]) for r in whole]
    _phase("ddp_train_loop", f"{note}; train_net R-50 student + R-101 teacher over smoke_lab "
           f"and the pseudo-labels of ddp_test_net, bs 8 (G=4, {4 // world} groups and "
           f"{n_rank} images a rank), {max_iter} iterations, {DDP_LOOP_WORKERS} loader processes "
           f"a rank, deterministic cuDNN: files {files} (rank 0's only; stats.jsonl one series, "
           f"loss {lines[0]['loss']:.4f} -> {lines[-1]['loss']:.4f}), one cls-loss forward and "
           f"backward a level a step on every rank at its rows, the ranks' parameters and momenta "
           f"bit-equal; a {world}-rank run resumed in a fresh directory from model_iter{snap}.pkl "
           f"ends bit-identical on every rank; iteration ms by rank {_fmt(iter_ms)} (medians), "
           f"process CPU ms an iteration {_fmt(cpu_ms, 1)}; the world (start, the run, the "
           f"resumed run) {world_s:.1f} s; {gpu}", time.perf_counter() - t0)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": [(r["launches"]["cls_fwd"], r["launches"]["cls_bwd"]) for r in whole]}


PARTIAL = {
    "nms_kernel": lambda torch, a, rng: phase_nms(torch, rng, a.iters, a.warmup),
    "cls_loss_kernels": lambda torch, a, rng: phase_cls_losses(torch, a.seed, a.batch, a.groups,
                                                               a.iters, a.warmup),
    "joint_step": lambda torch, a, rng: phase_joint_step(torch, a.seed, a.groups, a.iters,
                                                         a.warmup),
    "roi_align_kernel": lambda torch, a, rng: phase_roi_align(torch, a.seed, a.batch, a.iters,
                                                              a.warmup, ROI_TIMERS),
    "roi_align_bwd_kernel": lambda torch, a, rng: phase_roi_align_bwd(
        torch, a.seed, a.batch, a.iters, a.warmup, ROI_TIMERS),
    "faster_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "faster_rcnn_train", FASTER_CFG, a.seed + 4, a.groups, a.iters, a.warmup,
        ROI_TIMERS),
    "mask_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "mask_rcnn_train", MASK_CFG, a.seed + 5, a.groups, a.iters, a.warmup, ROI_TIMERS),
    "keypoint_rcnn_infer": lambda torch, a, rng: phase_rcnn_infer(
        torch, "keypoint_rcnn_infer", KEYPOINT_CFG, a.seed + 11, a.batch, a.iters, a.warmup),
    "keypoint_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "keypoint_rcnn_train", KEYPOINT_CFG, a.seed + 12, a.groups, a.iters, a.warmup,
        ROI_TIMERS),
    "keypoint_test_net": lambda torch, a, rng: phase_keypoint_test_net(torch, a.seed + 13,
                                                                       a.loop_data),
    "sad_train_loop": lambda torch, a, rng: phase_sad_train_loop(torch, a.seed + 6, a.iters,
                                                                 a.warmup, a.loop_data),
    "mask_rcnn_train_loop": lambda torch, a, rng: phase_mask_rcnn_train_loop(torch,
                                                                             a.loop_data),
    "test_net": lambda torch, a, rng: phase_test_net(torch, a.seed + 7, a.loop_data,
                                                     a.batch_imgs),
    "cls_loss_kernels_500": lambda torch, a, rng: phase_cls_losses(
        torch, a.seed, a.batch, a.groups, a.iters, a.warmup, LEVEL_HW_500,
        "cls_loss_kernels_500", levels_only=True),
    "label_assign": lambda torch, a, rng: phase_label_assign(torch, a.loop_data),
    "x101_teacher_infer": lambda torch, a, rng: phase_infer(
        torch, "x101_teacher_infer", TEACHER_500_CFG, a.seed + 8, a.batch, a.iters, a.warmup,
        canvas=(512, 896), profile=True),
    "joint_step_500": lambda torch, a, rng: phase_joint_step(
        torch, a.seed + 9, a.groups, a.iters, a.warmup, "joint_step_500", STUDENT_500_CFG,
        TEACHER_500_CFG, LEVEL_HW_500, profile=True),
    "fold_affine": lambda torch, a, rng: phase_fold_affine(torch, a.seed, a.batch, a.groups,
                                                           a.iters, a.warmup),
    "softmax_step": lambda torch, a, rng: phase_softmax_step(torch, a.seed + 10, a.groups,
                                                             a.iters, a.warmup),
    "fast_rcnn_infer": lambda torch, a, rng: phase_fast_rcnn_infer(
        torch, a.seed + 14, a.batch, a.iters, a.warmup, ROI_TIMERS),
    "fast_rcnn_train": lambda torch, a, rng: phase_rcnn_train(
        torch, "fast_rcnn_train", FAST_CFG, a.seed + 15, a.groups, a.iters, a.warmup, ROI_TIMERS),
    "proposal_pipeline": lambda torch, a, rng: phase_proposal_pipeline(
        torch, a.seed + 16, a.loop_data, a.iters, a.warmup),
    "tta_test_net": lambda torch, a, rng: phase_tta_test_net(torch, a.seed + 17, a.loop_data),
    "c4_rcnn_infer": lambda torch, a, rng: {
        "faster": phase_ss_infer(torch, "c4_faster_rcnn_infer", C4_FASTER_CFG, a.seed + 18,
                                 a.batch, a.iters, a.warmup),
        "mask": phase_ss_infer(torch, "c4_mask_rcnn_infer", C4_MASK_CFG, a.seed + 19, a.batch,
                               a.iters, a.warmup)},
    "c4_rcnn_train": lambda torch, a, rng: phase_ss_train(
        torch, "c4_rcnn_train", C4_MASK_CFG, a.seed + 20, SS_GROUPS, a.iters, a.warmup,
        v0up_too=True),
    "vgg16_rcnn": lambda torch, a, rng: phase_vgg16(torch, a.seed + 21, a.batch, a.iters,
                                                    a.warmup),
    "rfcn_ohem": lambda torch, a, rng: {
        "infer": phase_ss_infer(torch, "rfcn_ohem_infer", RFCN_CFG, a.seed + 22, a.batch,
                                a.iters, a.warmup),
        "train": phase_ss_train(torch, "rfcn_ohem_train", RFCN_CFG, a.seed + 23, SS_GROUPS,
                                a.iters, a.warmup)},
    "c4_test_net": lambda torch, a, rng: phase_c4_test_net(torch, a.seed + 24, a.loop_data),
    "export_serving": lambda torch, a, rng: phase_export_serving(
        torch, a.seed + 25, a.batch, a.iters, a.warmup, a.loop_data),
    "voc_test_net": lambda torch, a, rng: phase_voc_test_net(torch, a.seed + 26, a.loop_data,
                                                             a.iters, a.warmup),
    "cityscapes_test_net": lambda torch, a, rng: phase_cityscapes_test_net(
        torch, a.seed + 27, a.loop_data, a.iters, a.warmup),
    "vid_test_net": lambda torch, a, rng: phase_vid_test_net(torch, a.seed + 28, a.loop_data),
    "ddp_joint_step": lambda torch, a, rng: phase_ddp_step(torch, "ddp_joint_step", a.seed,
                                                           a.groups, DDP_TIMED_STEPS, a.gpu),
    "ddp_rcnn_step": lambda torch, a, rng: phase_ddp_step(torch, "ddp_rcnn_step", a.seed + 5,
                                                          a.groups, DDP_TIMED_STEPS, a.gpu),
    "ddp_test_net": lambda torch, a, rng: phase_ddp_test_net(torch, a.seed + 7, a.loop_data,
                                                             a.ddp, a.gpu),
    # trains on ddp_test_net's pseudo-labels: runs that phase first when it has not run
    "ddp_train_loop": lambda torch, a, rng: phase_ddp_train_loop(
        torch, a.loop_data, a.ddp if "pseudo" in a.ddp else (
            PARTIAL["ddp_test_net"](torch, a, rng) and a.ddp), a.gpu),
    "spatial_infer": lambda torch, a, rng: phase_spatial_infer(torch, a.seed + 29, a.batch,
                                                               a.iters, a.warmup, a.gpu),
    "spatial_joint_step": lambda torch, a, rng: phase_spatial_joint_step(
        torch, a.seed + 30, a.iters, a.warmup, a.gpu),
    "multislice_joint_step": lambda torch, a, rng: phase_multislice_joint_step(
        torch, a.seed + 30, a.iters, a.warmup, a.gpu),
    "span_train_loop": lambda torch, a, rng: phase_span_train_loop(
        torch, a.loop_data, a.iters, a.warmup, a.gpu),
}
# the RoIAlign forward's calls at the main paths' shapes, filled by the phases
# above and timed on the device by phase_roi_align_device after the main paths
ROI_TIMERS = {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--groups", type=int, default=4, help="loss groups of 2 images, joint step")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--only", default="", help="comma-separated phases to run alone while "
                   "working on one (no result lines are printed): " + ", ".join(PARTIAL))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import sad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: sad_tpu_torch is not importable from {REPO}: {e}", file=sys.stderr)
        return 3
    import tempfile

    adopted = _adopt_orphans()
    # the workflow phases' synthetic COCO and runs, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as loop_data:
        args.loop_data = loop_data
        args.batch_imgs = {}  # the serving phases' imgs/s, printed beside test_net's
        args.ddp = {}  # ddp_test_net's pseudo-labels, which ddp_train_loop trains on
        try:
            return _main(torch, args)
        finally:
            # every process the run started is ended before it returns
            left = _end_descendants()
            print(f"chip_smoke: {len(left)} processes still ran at the end (subreaper "
                  f"{'on' if adopted else 'off'}), ended: {left}", file=sys.stderr, flush=True)


def _main(torch, args) -> int:
    from sad_tpu_torch.device import nvidia_smi_line, set_tf32
    from sad_tpu_torch import native
    from sad_tpu_torch.ops import _build, cls_loss_kernel, nms_kernel, roi_align_kernel

    t0 = time.perf_counter()
    gpu = nvidia_smi_line()
    args.gpu = gpu
    tf32 = set_tf32(False)
    lib = _build.load_library()
    t_host = time.perf_counter()
    host_lib = native.load()  # g++, before any loader process spawns
    host_s = time.perf_counter() - t_host
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    _phase("env", f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; TF32 {tf32}; "
           f"kernels built in {lib.build_seconds:.2f} s ({'cached' if lib.cached else 'nvcc'}, "
           f"{os.path.relpath(lib.path, REPO)}); ptxas: {regs}; host kernels (g++) "
           f"{host_s:.2f} s ({os.path.basename(host_lib._name)})", time.perf_counter() - t0)

    rng = np.random.RandomState(args.seed)
    if args.only:
        outs = {name: PARTIAL[name](torch, args, rng) for name in args.only.split(",")}
        if "cls_loss_kernels" in outs:
            phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                             outs["cls_loss_kernels"])
        if "cls_loss_kernels_500" in outs:
            phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                             outs["cls_loss_kernels_500"], LEVEL_HW_500, "cls_loss_levels_500")
        if ROI_TIMERS:
            phase_roi_align_device(torch, ROI_TIMERS, args.iters, args.warmup)
        print("partial run: no result")
        return 0
    nms_stats = phase_nms(torch, rng, args.iters, args.warmup)
    roi_stats = PARTIAL["roi_align_kernel"](torch, args, rng)
    roi_bwd_stats = PARTIAL["roi_align_bwd_kernel"](torch, args, rng)
    fwd_stats, bwd_stats = PARTIAL["cls_loss_kernels"](torch, args, rng)
    fwd500, bwd500 = PARTIAL["cls_loss_kernels_500"](torch, args, rng)

    # the RetinaNet serving path: every count set to 0 just before it, read just after
    nms_kernel.launches = roi_align_kernel.launches = 0
    cls_loss_kernel.fwd_launches = cls_loss_kernel.bwd_launches = 0
    cls_loss_kernel.fwd_by_rows, cls_loss_kernel.bwd_by_rows = {}, {}
    student_imgs = phase_infer(torch, "student_infer", STUDENT_CFG, args.seed, args.batch,
                               args.iters, args.warmup)["imgs_per_s"]
    phase_infer(torch, "teacher_infer", TEACHER_CFG, args.seed + 1, args.batch,
                args.iters, args.warmup)
    nms_launches = nms_kernel.launches
    # the training path: the counts are set to 0 inside, after its comparisons
    cls_launches, cls_by_level = PARTIAL["joint_step"](torch, args, rng)
    for i, stats in enumerate((fwd_stats, bwd_stats)):
        for lvl in stats["levels"]:
            lvl["launches"] = cls_by_level[lvl["level"]][i]
    # the R-CNN serving paths: the counts are set to 0 inside, after the comparisons
    faster = phase_rcnn_infer(torch, "faster_rcnn_infer", FASTER_CFG, args.seed + 2, args.batch,
                              args.iters, args.warmup)
    mask = phase_rcnn_infer(torch, "mask_rcnn_infer", MASK_CFG, args.seed + 3, args.batch,
                            args.iters, args.warmup)
    if nms_kernel.launches != mask["nms_launches"] or (
            roi_align_kernel.launches != mask["roi_align_launches"]):
        raise AssertionError("a kernel was launched after the R-CNN serving runs")
    # Keypoint R-CNN serving: the counts are set to 0 inside, after the comparisons
    kps = PARTIAL["keypoint_rcnn_infer"](torch, args, rng)
    kps_batches = kps["nms_launches"] // 2
    # Fast R-CNN serving on proposals: the counts are set to 0 inside, after the comparisons
    fast = PARTIAL["fast_rcnn_infer"](torch, args, rng)
    rcnn_batches = (faster["nms_launches"] + mask["nms_launches"]) // 2
    args.batch_imgs = {"student": student_imgs, "mask": mask["imgs_per_s"]}
    # the R-CNN training steps: the counts are set to 0 inside, after the comparisons
    faster_t = PARTIAL["faster_rcnn_train"](torch, args, rng)
    mask_t = PARTIAL["mask_rcnn_train"](torch, args, rng)
    if _kernel_counts() != mask_t["launches"]:
        raise AssertionError("a kernel was launched after the R-CNN training runs")
    kps_t = PARTIAL["keypoint_rcnn_train"](torch, args, rng)
    if _kernel_counts() != kps_t["launches"]:
        raise AssertionError("a kernel was launched after the keypoint training run")
    fast_t = PARTIAL["fast_rcnn_train"](torch, args, rng)
    if _kernel_counts() != fast_t["launches"]:
        raise AssertionError("a kernel was launched after the Fast R-CNN training run")
    # the training workflow: the counts are set to 0 inside, just before each train_net
    # run, and read just after it (the resume checks that follow launch more)
    sad_loop = PARTIAL["sad_train_loop"](torch, args, rng)
    mask_loop = PARTIAL["mask_rcnn_train_loop"](torch, args, rng)
    # the evaluation path: the counts are set to 0 inside, just before each
    # test_net run with the kernels, and read just after it
    evals = PARTIAL["test_net"](torch, args, rng)
    eval_nms = evals["student"]["launches"][0]
    eval_rcnn = evals["mask"]["launches"][0] // 2
    eval_roi = evals["mask"]["launches"][1] // 2
    # Keypoint R-CNN's test_net and train_net: the counts set to 0 inside, just
    # before each run with the kernels, and read just after it
    kps_eval = PARTIAL["keypoint_test_net"](torch, args, rng)
    kps_eval_batches = kps_eval["launches"][0] // 2
    kps_loop = kps_eval["loop_launches"]
    # the two-stage workflow (RPN-only proposals -> Fast R-CNN train_net and
    # test_net) and test-time augmentation through test_net: the counts set to
    # 0 inside, just before each run with the kernels, and read just after it
    prop = PARTIAL["proposal_pipeline"](torch, args, rng)
    tta = PARTIAL["tta_test_net"](torch, args, rng)
    tta_rcnn = tta["tta"]["nms_each"] + tta["tta_soft_nms"]["nms_each"]
    tta_box = tta_rcnn + tta["kps_aug"]["box_roi"]
    tta_aux = sum(r["aux_roi"] for r in tta.values())
    # the paper's R-101 <- X-101-64x4d pair at scale 500: the host's label
    # assignment, then the teacher's serving path and the joint step, each
    # with every count set to 0 just before it and read just after
    PARTIAL["label_assign"](torch, args, rng)
    _reset_counts()
    x101_nms = PARTIAL["x101_teacher_infer"](torch, args, rng)["nms_launches"]
    if any(_all_counts()[1:]) or x101_nms < 1:
        raise AssertionError(f"x101_teacher_infer: launches {_all_counts()}, want NMS only")
    cls500_launches, cls500_by_level = PARTIAL["joint_step_500"](torch, args, rng)
    for i, stats in enumerate((fwd500, bwd500)):
        for lvl in stats["levels"]:
            lvl["launches"] = cls500_by_level[lvl["level"]][i]
    # FOLD_AFFINE on against off, and the softmax focal loss's step (no kernel of ours)
    PARTIAL["fold_affine"](torch, args, rng)
    _reset_counts()
    PARTIAL["softmax_step"](torch, args, rng)
    if any(_all_counts()):
        raise AssertionError(f"softmax_step launched kernels {_all_counts()}")
    phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                     (fwd_stats, bwd_stats))
    phase_cls_levels(torch, args.seed, args.batch, args.groups, args.iters, args.warmup,
                     (fwd500, bwd500), LEVEL_HW_500, "cls_loss_levels_500")
    phase_roi_align_device(torch, ROI_TIMERS, args.iters, args.warmup)
    # the forward's device time on the rois the training steps sampled, beside
    # the spread rois' at the same shapes
    for key in ("box", "mask"):  # the keypoint step's res-14 rois are the mask row's shape
        roi_bwd_stats[f"fwd_{key}"]["device_ms_own_rois"] = {
            k.split(":")[1].split(" ")[0]: st["device_ms"] for k, (_, st) in ROI_TIMERS.items()
            if k.startswith(f"{key}_train:")}
    train_steps = faster_t["steps"] + mask_t["steps"]
    # the single-scale family (C4, VGG16, R-FCN with OHEM), after the device-time
    # phases: its profiled idle shares would come before them otherwise, and late in
    # a process the profiler drops records (PERF.md section 6). The counts are set
    # to 0 inside, after the comparisons, just before each main path, read just after
    c4 = PARTIAL["c4_rcnn_infer"](torch, args, rng)
    c4_t = PARTIAL["c4_rcnn_train"](torch, args, rng)
    if _kernel_counts() != c4_t["v0up"]["launches"]:
        raise AssertionError("a kernel was launched after the C4 training runs")
    vgg = PARTIAL["vgg16_rcnn"](torch, args, rng)
    rfcn = PARTIAL["rfcn_ohem"](torch, args, rng)
    if _kernel_counts() != rfcn["train"]["launches"]:
        raise AssertionError("a kernel was launched after the R-FCN training run")
    c4_eval = PARTIAL["c4_test_net"](torch, args, rng)
    # the serving export and the VOC, Cityscapes and VID evaluators through
    # test_net: each main path's counts set to 0 just before it and read just
    # after (the exported program's in the child process that serves it)
    exported = PARTIAL["export_serving"](torch, args, rng)
    voc = PARTIAL["voc_test_net"](torch, args, rng)
    cs = PARTIAL["cityscapes_test_net"](torch, args, rng)
    vid = PARTIAL["vid_test_net"](torch, args, rng)
    # data parallelism, last: W ranks, processes of their own, each setting
    # its counts to 0 just before its run and reading them just after; in
    # this process only ddp_test_net's one-process references launch (its
    # last one read last)
    _reset_counts()
    ddp_joint = PARTIAL["ddp_joint_step"](torch, args, rng)
    ddp_rcnn = PARTIAL["ddp_rcnn_step"](torch, args, rng)
    if any(_all_counts()):
        raise AssertionError(f"the data-parallel steps launched kernels in the main process "
                             f"{_all_counts()}")
    ddp_eval = PARTIAL["ddp_test_net"](torch, args, rng)
    ddp_loop = PARTIAL["ddp_train_loop"](torch, args, rng)
    if _all_counts() != ddp_eval["one_launches"]:
        raise AssertionError(f"the data-parallel phases launched kernels in the main process "
                             f"{_all_counts()} beside the one-process test_net's "
                             f"{ddp_eval['one_launches']}")
    ddp_rows = ddp_rcnn["launches"]
    # the 'model' mesh axis: ranks, processes of their own, each setting its
    # counts to 0 just before its main path and reading them just after; in
    # this process only the kernel rows' comparisons launch, after them
    sp_infer = PARTIAL["spatial_infer"](torch, args, rng)
    sp_step = PARTIAL["spatial_joint_step"](torch, args, rng)
    # the multislice mesh and R-CNN loss groups over ranks: the same, each rank
    # setting its counts to 0 just before its main path and reading them just after
    ms_step = phase_multislice_joint_step(torch, args.seed + 30, args.iters, args.warmup,
                                          args.gpu, one=sp_step["one"])
    span = PARTIAL["span_train_loop"](torch, args, rng)

    nms_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/nms.cu",
        "replaces": "sad_tpu/ops/pallas_nms.py:45 (_nms_kernel) and :103 (_nms_kernel_batched)",
        "library_ms": None,
    }
    roi_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/roi_align.cu",
        "replaces": "sad_tpu/ops/pallas_roi_align.py:234 (_mlra_kernel)",
        "library_ms": None,
    }
    roi_bwd_entry = {
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/roi_align.cu",
        "replaces": "sad_tpu/ops/pallas_roi_align.py:505 (_mlra_bwd_kernel)",
        "library_ms": None,
    }
    print(json.dumps({"kernels": [{
        # RetinaNet decode shape; launches of the two RetinaNet serving runs
        "name": "greedy_nms_sorted", "launches": nms_launches, **nms_stats["decode"], **nms_entry,
        "test_net_launches": eval_nms, "ddp_test_net_launches": ddp_eval["launches"],
        "vid_test_net_launches": vid["launches"][0],
    }, {
        # the exported student program (8 x 5000 -> 100) in its child process, timed on
        # the batch's own candidates; dispatch_us: host microseconds a call through the
        # custom op and through nms_cuda directly
        "name": "nms@export", "launches": exported["launches"], **exported["nms_stats"],
        **nms_entry, "dispatch_us": exported["dispatch_us"],
    }, {
        # VOC2007 test_net with the VGG16 YAML: RPN 8 x 6000 -> 300, decode 8 x (300 x 20)
        # -> 100, the box RoIAlign R = 8 x 300, res 7, C = 512 on the stride-16 map
        "name": "nms@voc_rpn", "launches": voc["launches"][0] // 2, **voc["rpn"], **nms_entry,
    }, {
        "name": "nms@voc_decode", "launches": voc["launches"][0] // 2, **voc["decode"],
        **nms_entry,
    }, {
        "name": "roi_align_fwd@voc_box", "launches": voc["launches"][1], **voc["box"],
        **roi_entry,
    }, {
        # Cityscapes test_net with Mask R-CNN R-50-FPN on 1024x2048: RPN 40 x 1000 -> 1000,
        # decode 8 x (1000 x 8) -> 100, box RoIAlign R = 8000 res 7, mask R = 800 res 14
        "name": "nms@cs_rpn", "launches": cs["launches"][0] // 2, **cs["rpn"], **nms_entry,
    }, {
        "name": "nms@cs_decode", "launches": cs["launches"][0] // 2, **cs["decode"],
        **nms_entry,
    }, {
        "name": "roi_align_fwd@cs_box", "launches": cs["launches"][1] // 2, **cs["box"],
        **roi_entry,
    }, {
        "name": "roi_align_fwd@cs_mask", "launches": cs["launches"][1] // 2, **cs["mask"],
        **roi_entry,
    }, {
        # the same decode shape (8 x 5 levels x 1000 -> 100): the X-101 teacher at scale 500
        "name": "greedy_nms_sorted@decode_500", "launches": x101_nms, **nms_stats["decode"],
        **nms_entry,
    }, {
        # one launch a batch of each R-CNN serving run (Faster, Mask, Keypoint), at the
        # RPN shape; keypoint_launches: the Keypoint R-CNN run's share
        "name": "greedy_nms_sorted@rpn", "launches": rcnn_batches + kps_batches,
        **nms_stats["rpn"], **nms_entry, "keypoint_launches": kps_batches,
        "test_net_launches": eval_rcnn + kps_eval_batches,
        "keypoint_test_net_launches": kps_eval_batches,
        # one a box pass of the three TTA runs (18 passes a Mask R-CNN batch)
        "tta_test_net_launches": tta_box,
    }, {
        "name": "greedy_nms_sorted@rcnn_decode", "launches": rcnn_batches,
        **nms_stats["rcnn_decode"], **nms_entry, "test_net_launches": eval_rcnn,
        "tta_test_net_launches": tta_rcnn,
    }, {
        # Keypoint R-CNN's detection NMS: one foreground class, 8 x 1000 -> 100, timed
        # on the serving batch's own candidates
        "name": "greedy_nms_sorted@kps_decode", "launches": kps_batches,
        **kps["nms_decode"], **nms_entry, "test_net_launches": kps_eval_batches,
        "tta_test_net_launches": tta["kps_aug"]["nms_each"],
    }, {
        # RPN-only serving (test_net with rpn_R-50-FPN.yaml): 5 levels x 8 images of 1000
        # candidates -> 2000 slots, timed on a seeded batch's own candidates
        "name": "greedy_nms_sorted@rpn_only", "launches": prop["rpn_launches"][0],
        **prop["nms_stats"], **nms_entry,
    }, {
        # Fast R-CNN's detection NMS: 8 x (2000 proposals x 80 classes) -> 100, timed on
        # the serving batch's own candidates
        "name": "greedy_nms_sorted@fast_rcnn_decode", "launches": fast["nms_launches"],
        **fast["nms_stats"], **nms_entry, "test_net_launches": prop["test_launches"][0],
    }, {
        # Fast R-CNN serving's box RoIAlign: R = 8 x 2000, res 7
        "name": "roi_align_fwd@fast_rcnn", "launches": fast["roi_align_launches"],
        **fast["roi_stats"], **roi_entry, "test_net_launches": prop["test_launches"][1],
    }, {
        # the Fast R-CNN step's box RoIAlign backward on the rois it sampled from its
        # proposals (R = 4096, res 7)
        "name": "roi_align_bwd_gather@fast_rcnn_train", "launches": fast_t["launches"][2],
        **fast_t["own_stats"]["box"], **roi_bwd_entry,
        "train_loop_launches": prop["train_launches"][2],
    }, {
        # box RoIAlign: one launch a batch of the three R-CNN runs; mask: of the Mask R-CNN
        # run and, at the same shape (R=800, res 14), the keypoint RoIAlign of Keypoint R-CNN
        "name": "roi_align_fwd@box", **roi_stats["box"], **roi_entry,
        "launches": faster["roi_align_launches"] + mask["roi_align_launches"] // 2
        + kps_batches, "keypoint_launches": kps_batches,
        "test_net_launches": eval_roi + kps_eval_batches,
        "keypoint_test_net_launches": kps_eval_batches, "tta_test_net_launches": tta_box,
    }, {
        "name": "roi_align_fwd@mask", **roi_stats["mask"], **roi_entry,
        "launches": mask["roi_align_launches"] // 2 + kps_batches,
        "keypoint_launches": kps_batches, "test_net_launches": eval_roi + kps_eval_batches,
        "keypoint_test_net_launches": kps_eval_batches,
        # the mask / keypoint head on the merged boxes and once a mask / keypoint TTA pass
        "tta_test_net_launches": tta_aux,
    }, {
        # the training steps: one NMS, one box RoIAlign pair a step of the three families;
        # the mask pair and the mask target crop (forward only) a step of Mask R-CNN; the
        # keypoint pair (res 14, the mask rows' shape) a step of Keypoint R-CNN
        "name": "greedy_nms_sorted@rpn_train", "launches": train_steps + kps_t["steps"],
        "keypoint_launches": kps_t["steps"],
        "train_loop_launches": mask_loop["launches"][0],
        "keypoint_train_loop_launches": kps_loop[0],
        "ddp_launches": [la["nms"] for la in ddp_rows],
        **nms_stats["rpn_train"], **nms_entry,
    }, {
        "name": "roi_align_fwd@box_train",
        "launches": train_steps + kps_t["steps"] + fast_t["steps"],
        "keypoint_launches": kps_t["steps"], "fast_rcnn_launches": fast_t["steps"],
        "fast_rcnn_train_loop_launches": prop["train_launches"][1],
        "train_loop_launches": mask_loop["launches"][1] // 3,
        "keypoint_train_loop_launches": kps_loop[1] // 2,
        "ddp_launches": [la["roi_align_fwd"] // 3 for la in ddp_rows],
        **roi_bwd_stats["fwd_box"], **roi_entry,
    }, {
        "name": "roi_align_fwd@mask_train", "launches": mask_t["steps"] + kps_t["steps"],
        "keypoint_launches": kps_t["steps"],
        "train_loop_launches": mask_loop["launches"][1] // 3,
        "keypoint_train_loop_launches": kps_loop[1] // 2,
        "ddp_launches": [la["roi_align_fwd"] // 3 for la in ddp_rows],
        **roi_bwd_stats["fwd_mask"], **roi_entry,
    }, {
        "name": "roi_align_fwd@mask_targets", "launches": mask_t["steps"],
        "train_loop_launches": mask_loop["launches"][1] // 3,
        "ddp_launches": [la["roi_align_fwd"] // 3 for la in ddp_rows],
        **mask_t["target_stats"], **roi_entry,
    }, {
        "name": "roi_align_bwd_gather@box", "launches": train_steps + kps_t["steps"],
        "keypoint_launches": kps_t["steps"],
        "train_loop_launches": mask_loop["launches"][2] // 2,
        "keypoint_train_loop_launches": kps_loop[2] // 2,
        "ddp_launches": [la["roi_align_bwd"] // 2 for la in ddp_rows],
        **roi_bwd_stats["box"], **roi_bwd_entry,
    }, {
        "name": "roi_align_bwd_gather@mask", "launches": mask_t["steps"] + kps_t["steps"],
        "keypoint_launches": kps_t["steps"],
        "train_loop_launches": mask_loop["launches"][2] // 2,
        "keypoint_train_loop_launches": kps_loop[2] // 2,
        "ddp_launches": [la["roi_align_bwd"] // 2 for la in ddp_rows],
        **roi_bwd_stats["mask"], **roi_bwd_entry,
    }, {
        # the single-scale family. C4 serving's RPN: 8 x 6000 -> 1000 (sorted), one
        # launch a batch of the Faster and the Mask R-50-C4 runs and of c4_test_net's batches
        "name": "greedy_nms_sorted@c4_rpn", **c4["faster"]["rpn"], **nms_entry,
        "launches": (c4["faster"]["nms_launches"] + c4["mask"]["nms_launches"]) // 2,
        "test_net_launches": c4_eval["launches"][0] // 2,
    }, {
        # C4 serving's decode: 8 x (1000 rois x 80 classes) -> 100
        "name": "greedy_nms_sorted@c4_decode", **c4["faster"]["decode"], **nms_entry,
        "launches": (c4["faster"]["nms_launches"] + c4["mask"]["nms_launches"]) // 2,
        "test_net_launches": c4_eval["launches"][0] // 2,
    }, {
        # the C4 and VGG16 training RPN: 8 x 12,000 -> 2000, over the sort's 8192 cap: the
        # argmax loop; one a step (C4 v0upshare steps, the v0up step, the VGG16 step)
        "name": "greedy_nms_argmax@ss_rpn_train", **c4_t["rpn"], **nms_entry,
        "launches": c4_t["launches"][0] + c4_t["v0up"]["launches"][0]
        + vgg["train"]["launches"][0],
        "v0up_launches": c4_t["v0up"]["launches"][0],
        "vgg16_launches": vgg["train"]["launches"][0],
    }, {
        # VGG16 and R-FCN serving's RPN, 8 x 6000 -> 300 (sorted), and R-FCN's training
        # RPN at the same shape
        "name": "greedy_nms_sorted@ss_rpn_300", **vgg["infer"]["rpn"], **nms_entry,
        "launches": (vgg["infer"]["nms_launches"] + rfcn["infer"]["nms_launches"]) // 2
        + rfcn["train"]["launches"][0],
        "rfcn_launches": rfcn["infer"]["nms_launches"] // 2,
        "rfcn_train_launches": rfcn["train"]["launches"][0],
    }, {
        # VGG16 and R-FCN serving's decode: 8 x (300 rois x 80 classes) -> 100
        "name": "greedy_nms_sorted@ss_decode_24000", **rfcn["infer"]["decode"], **nms_entry,
        "launches": (vgg["infer"]["nms_launches"] + rfcn["infer"]["nms_launches"]) // 2,
        "rfcn_launches": rfcn["infer"]["nms_launches"] // 2,
    }, {
        # C4 serving's box RoIAlign: R = 8000, res 14, C = 1024 on the 50x84 res4 map
        "name": "roi_align_fwd@c4_box", **c4["faster"]["box"], **roi_entry,
        "launches": c4["faster"]["roi_align_launches"] + c4["mask"]["roi_align_launches"] // 2,
        "test_net_launches": c4_eval["launches"][1] // 2,
    }, {
        # the cascaded mask branch: R = 800 kept boxes, res 14
        "name": "roi_align_fwd@c4_mask", **c4["mask"]["mask"], **roi_entry,
        "launches": c4["mask"]["roi_align_launches"] // 2,
        "test_net_launches": c4_eval["launches"][1] // 2,
    }, {
        # the C4 step's box rois (R = 4096, res 14) and the v0up step's
        "name": "roi_align_fwd@c4_box_train", **c4_t["fwd_box_train"], **roi_entry,
        "launches": c4_t["steps"] + 1, "v0up_launches": 1,
    }, {
        # the C4 mask target crop (C = 1, res 14, the fg prefix), one a Mask step
        "name": "roi_align_fwd@c4_mask_targets", **c4_t["crop"], **roi_entry,
        "launches": c4_t["steps"] + 1, "v0up_launches": 1,
    }, {
        # v0up's own RoIAlign on the fg prefix (R = 8 x 128, res 14)
        "name": "roi_align_fwd@c4_v0up_mask_train", **c4_t["v0up"]["fwd_mask_train"],
        **roi_entry, "launches": 1,
    }, {
        # VGG16: serving R = 8 x 300, res 7, C = 512; the step's 8 x 128 rois
        "name": "roi_align_fwd@vgg16", **vgg["infer"]["box"], **roi_entry,
        "launches": vgg["infer"]["roi_align_launches"],
    }, {
        "name": "roi_align_fwd@vgg16_train", **vgg["train"]["fwd_box_train"], **roi_entry,
        "launches": vgg["train"]["launches"][1],
    }, {
        "name": "roi_align_bwd_gather@c4_box_train", **c4_t["bwd_box_train"], **roi_bwd_entry,
        "launches": c4_t["steps"] + 1, "v0up_launches": 1,
    }, {
        "name": "roi_align_bwd_gather@c4_v0up_mask_train", **c4_t["v0up"]["bwd_mask_train"],
        **roi_bwd_entry, "launches": 1,
    }, {
        "name": "roi_align_bwd_gather@vgg16_train", **vgg["train"]["bwd_box_train"],
        **roi_bwd_entry, "launches": vgg["train"]["launches"][2],
    }, {
        # P3's shape; "levels" holds every level's device time, bound and the launches
        # counted at that level's shape in the joint step
        "name": "cls_losses_fwd",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:152 (_fwd_kernel) and :284 (_fwd_kernel_aligned)",
        "launches": cls_launches[0], "train_loop_launches": sad_loop["launches"][3],
        "ddp_launches": [la["cls_fwd"] for la in ddp_joint["launches"]],
        "ddp_train_loop_launches": [f for f, _ in ddp_loop["launches"]],
        **fwd_stats, "library_ms": None,
    }, {
        "name": "cls_losses_bwd",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:214 (_bwd_kernel) and :320 (_bwd_kernel_aligned)",
        "launches": cls_launches[1], "train_loop_launches": sad_loop["launches"][4],
        "ddp_launches": [la["cls_bwd"] for la in ddp_joint["launches"]],
        "ddp_train_loop_launches": [b for _, b in ddp_loop["launches"]],
        **bwd_stats, "library_ms": None,
    }, {
        # height-sharded serving (n_model = 2): the first rank's decode of the gathered
        # maps, 8 x 5000 -> 100, timed on its own candidates; the other rank launches none
        "name": "nms@spatial_decode", "launches": sp_infer["launches"],
        "other_rank_launches": sp_infer["other_launches"], **sp_infer["nms_stats"],
        **nms_entry,
    }, {
        # the joint step on a 2 x 2 mesh: a rank's band of P3 (2 images x 40 of 80 rows,
        # 92,160 rows x 80, G = its 2 images), on the first rank's own inputs;
        # launches: each rank's at that shape
        "name": "cls_losses_fwd@band_p3", "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:152 (_fwd_kernel) and :284 (_fwd_kernel_aligned)",
        "launches": sp_step["launches"][0][0],
        "ranks_launches": [f for f, _ in sp_step["launches"]], **sp_step["fwd"],
        "library_ms": None,
    }, {
        "name": "cls_losses_bwd@band_p3", "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:214 (_bwd_kernel) and :320 (_bwd_kernel_aligned)",
        "launches": sp_step["launches"][0][1],
        "ranks_launches": [b for _, b in sp_step["launches"]], **sp_step["bwd"],
        "library_ms": None,
    }, {
        # the joint step on the multislice mesh (4 ranks as 2 nodes): a rank's P3 (one image,
        # 92,160 rows x 80, G = its image), on the first rank's own inputs; launches: each
        # rank's at that shape
        "name": "cls_losses_fwd@multislice_p3", "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:152 (_fwd_kernel) and :284 (_fwd_kernel_aligned)",
        "launches": ms_step["launches"][0][0],
        "ranks_launches": [f for f, _ in ms_step["launches"]], **ms_step["fwd"],
        "library_ms": None,
    }, {
        "name": "cls_losses_bwd@multislice_p3", "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:214 (_bwd_kernel) and :320 (_bwd_kernel_aligned)",
        "launches": ms_step["launches"][0][1],
        "ranks_launches": [b for _, b in ms_step["launches"]], **ms_step["bwd"],
        "library_ms": None,
    }, {
        # train_net's Mask R-CNN over 4 ranks as 2 nodes, one image a rank: the first rank's
        # training RPN (5 problems -> 2000, thr 0.7), its box rois' RoIAlign forward and its
        # backward, on its own first-step inputs; launches: the first rank's over its
        # iterations, each rank's beside
        "name": "nms@span_rpn", "launches": span["launches"][0]["nms"],
        "ranks_launches": [la["nms"] for la in span["launches"]], **span["nms"], **nms_entry,
    }, {
        "name": "roi_align_fwd@span", "launches": span["launches"][0]["roi_align_fwd"],
        "ranks_launches": [la["roi_align_fwd"] for la in span["launches"]], **span["fwd"],
        **roi_entry,
    }, {
        "name": "roi_align_bwd@span", "launches": span["launches"][0]["roi_align_bwd"],
        "ranks_launches": [la["roi_align_bwd"] for la in span["launches"]], **span["bwd"],
        **roi_bwd_entry,
    }, {
        # the R-101 <- X-101 joint step at scale 500: P3 at 516,096 rows; "levels" as above
        "name": "cls_losses_fwd@500",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:152 (_fwd_kernel) and :284 (_fwd_kernel_aligned)",
        "launches": cls500_launches[0], **fwd500, "library_ms": None,
    }, {
        "name": "cls_losses_bwd@500",
        "route": "cuda",
        "source": "sad_tpu_torch/csrc/cls_losses.cu",
        "replaces": "sad_tpu/ops/pallas_losses.py:214 (_bwd_kernel) and :320 (_bwd_kernel_aligned)",
        "launches": cls500_launches[1], **bwd500, "library_ms": None,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
