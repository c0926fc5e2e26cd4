from .lr_policy import get_lr_at_iter, lr_change_correction
from .optimizer import init_velocity, momentum_sgd_update, rescale_momentum
from .rcnn_train import make_rcnn_train_step
from .train_step import TrainState, batch_to_torch, make_train_step

__all__ = ["TrainState", "batch_to_torch", "get_lr_at_iter", "init_velocity",
           "lr_change_correction", "make_rcnn_train_step", "make_train_step", "momentum_sgd_update",
           "rescale_momentum"]
