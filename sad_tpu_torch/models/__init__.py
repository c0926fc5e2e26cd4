from .arch import ModelArch, arch_from_config
from .model_builder import bias_mask, compute_dtype, create_model, init_weights, trainable_mask
from .retinanet import RetinaNet

__all__ = ["ModelArch", "arch_from_config", "bias_mask", "compute_dtype", "create_model",
           "init_weights", "RetinaNet", "trainable_mask"]
