from .arch import ModelArch, arch_from_config
from .model_builder import compute_dtype, create_model, init_weights
from .retinanet import RetinaNet

__all__ = ["ModelArch", "arch_from_config", "compute_dtype", "create_model",
           "init_weights", "RetinaNet"]
