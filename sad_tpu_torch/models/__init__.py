from .arch import ModelArch, arch_from_config
from .model_builder import bias_mask, compute_dtype, create_model, init_weights, trainable_mask
from .rcnn import GeneralizedRCNN
from .retinanet import RetinaNet
from .single_scale import SingleScaleRCNN

__all__ = ["GeneralizedRCNN", "ModelArch", "arch_from_config", "bias_mask", "compute_dtype", "create_model",
           "init_weights", "RetinaNet", "SingleScaleRCNN", "trainable_mask"]
