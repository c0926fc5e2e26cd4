"""sad_tpu_torch: the PyTorch and CUDA port of sad_tpu, for NVIDIA Hopper.

sad_tpu (JAX on a TPU) stays the reference; this package imports torch and
never jax, and no module of sad_tpu either: it keeps its own copies of the
host modules it needs (config, anchors, minibatch, dataset, vis). Two
slices are ported:

  serving   uint8 canvas -> ResNet-FPN RetinaNet -> per-level top-k -> box
            decode -> class-wise greedy NMS (CUDA kernel, csrc/nms.cu) -> top 100
  training  the joint SAD step: one uint8 canvas normalised twice, the frozen
            teacher's forward, the student's forward and backward, focal +
            adaptive distillation + PowSum in two CUDA kernels
            (csrc/cls_losses.cu), select-smooth-L1, Caffe2 momentum SGD

  sad_tpu_torch.config    config schema, YAML loading, dataset catalog (copies)
  sad_tpu_torch.data      anchors, label assignment, minibatch builder, COCO
                          reader (copies), seeded synthetic inputs
  sad_tpu_torch.device    device choice (no silent CPU fallback), TF32 switches
  sad_tpu_torch.models    ResNet/FPN/RetinaNet as nn.Modules, Flax-named,
                          float32 parameters, compute in COMPUTE_DTYPE
  sad_tpu_torch.convert   sad_tpu param trees and checkpoints <-> state_dict
  sad_tpu_torch.ops       image normalisation, box decode, NMS, the loss ops
                          and the fused cls losses, with their kernels
  sad_tpu_torch.train     make_train_step, momentum SGD, LR schedule
  sad_tpu_torch.eval      batched inference, dataset inference, pseudo-labels
  sad_tpu_torch.tools     infer_simple CLI, profile_infer, profile_train

sad_tpu_torch/configs/ holds the flagship student and teacher YAMLs. See
ROADMAP.md for what is still to port (train loop, TTA, R-CNN families).
"""

__version__ = "0.2.0"
