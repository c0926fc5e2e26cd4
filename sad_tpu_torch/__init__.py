"""sad_tpu_torch: the PyTorch and CUDA port of sad_tpu, for NVIDIA Hopper.

sad_tpu (JAX on a TPU) stays the reference; this package imports torch and
never jax. Its first slice is the serving path shared by the student (scored
on COCO) and the frozen teacher (whose detections become pseudo-labels):

  uint8 canvas -> ResNet-FPN RetinaNet -> per-level top-k -> box decode
  -> class-wise greedy NMS (hand-written CUDA kernel, csrc/nms.cu) -> top 100

  sad_tpu_torch.device    device choice (no silent CPU fallback), TF32 switches
  sad_tpu_torch.models    ResNet/FPN/RetinaNet as nn.Modules, Flax-named
  sad_tpu_torch.convert   sad_tpu param trees and checkpoints <-> state_dict
  sad_tpu_torch.ops       image normalisation, box decode, NMS and its kernel
  sad_tpu_torch.eval      batched inference, dataset inference, pseudo-labels
  sad_tpu_torch.tools     infer_simple CLI

Configuration and dataset I/O are sad_tpu's own host modules
(sad_tpu.config, sad_tpu.data.*), which import no jax; sad_tpu_torch/configs/
holds the flagship student and teacher YAMLs. See ROADMAP.md for what is
still to port (training, TTA, R-CNN families).
"""

__version__ = "0.1.0"
