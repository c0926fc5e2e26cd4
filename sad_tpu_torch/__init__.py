"""sad_tpu_torch: the PyTorch and CUDA port of sad_tpu, for NVIDIA Hopper.

sad_tpu (JAX on a TPU) stays the reference; this package imports torch and
never jax, and no module of sad_tpu either: it keeps its own copies of the
host modules it needs (config, anchors, minibatch, dataset, vis). Ported:

  serving   uint8 canvas -> ResNet-FPN RetinaNet -> per-level top-k -> box
            decode -> class-wise greedy NMS (CUDA kernel, csrc/nms.cu) -> top 100;
            Faster / Mask R-CNN R-50-FPN (RoIAlign, csrc/roi_align.cu)
  training  the joint SAD step: one uint8 canvas normalised twice, the frozen
            teacher's forward, the student's forward and backward, focal +
            adaptive distillation + PowSum in two CUDA kernels
            (csrc/cls_losses.cu), select-smooth-L1, Caffe2 momentum SGD; the
            Faster / Mask R-CNN step; the loop around both (train_net), over
            W ranks with torchrun (gradients summed over the ranks)

  sad_tpu_torch.config    config schema, YAML loading, dataset catalog (copies)
  sad_tpu_torch.native    the host kernels (IoU, the float32 label-assignment
                          pass, NMS, soft-NMS), C++ built by g++ (a copy)
  sad_tpu_torch.data      anchors, label assignment, minibatch builders, COCO
                          reader, synthetic COCO (copies), the threaded and
                          multi-process loaders, the host -> card prefetcher
  sad_tpu_torch.device    device choice (no silent CPU fallback), TF32 switches
  sad_tpu_torch.models    ResNet/FPN/RetinaNet/R-CNN as nn.Modules, Flax-named,
                          float32 parameters, compute in COMPUTE_DTYPE
  sad_tpu_torch.convert   sad_tpu param trees <-> state_dict
  sad_tpu_torch.ops       image normalisation, box decode, NMS, RoIAlign, the
                          loss ops and the fused cls losses, with their kernels
  sad_tpu_torch.parallel  data parallelism over GPUs (torch.distributed: NCCL,
                          gloo on the CPU), per-rank shards, the rank launcher
  sad_tpu_torch.train     the train steps, momentum SGD, LR schedule, the
                          train loop, checkpoints (sad_tpu's native format)
  sad_tpu_torch.eval      batched inference, dataset inference, pseudo-labels
  sad_tpu_torch.tools     train_net and infer_simple CLIs, the profile_* tools
  sad_tpu_torch.utils     stats, timer, logging, model summary, masks, vis

sad_tpu_torch/configs/ holds the flagship YAMLs and the paper's scale-500
R-101 <- X-101-64x4d pair. See ROADMAP.md for what is still to port
(TTA, the rest of the R-CNN families).
"""

__version__ = "0.2.0"
__all__ = ["parallel"]


def __getattr__(name):
    # sad_tpu_torch.parallel imports torch.distributed: loaded on first use,
    # so that the loader's worker processes (numpy only) do not import torch
    if name == "parallel":
        import importlib

        return importlib.import_module(".parallel", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
