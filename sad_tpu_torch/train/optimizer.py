"""Momentum SGD with Caffe2/Detectron semantics (ref:
sad_tpu/train/optimizer.py:38-128; caffe2/sgd/momentum_sgd_op.h:23-51,
detectron/lib/modeling/optimizer.py:95-130).

Per trainable parameter:

    g_eff = 2 * g                   for biases (2x LR, no weight decay)
          = g + weight_decay * w    otherwise  (WeightedSum, optimizer.py:121)
    V     = momentum * V + lr * g_eff
    w     = w - V

Frozen parameters (AffineChannel scale/bias, the FREEZE_AT stages) get no
update and keep their velocity. Unlike sad_tpu's pure pytree transform, the
update works in place on lists of tensors with ``torch._foreach_*`` (one
launch per list instead of one per parameter), and it also overwrites the
gradient tensors it is given. The momentum-history rescale on LR changes
(detector.py:628-648) is ``rescale_momentum``, applied by the host loop.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn


def init_velocity(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero momentum for every parameter of the model, keyed by name."""
    return {name: torch.zeros_like(p) for name, p in model.named_parameters()}


@torch.no_grad()
def momentum_sgd_update(
    params: Sequence[torch.Tensor],  # the trainable parameters
    grads: Sequence[torch.Tensor],  # their gradients (overwritten)
    velocity: Sequence[torch.Tensor],  # their momentum (updated in place)
    is_bias: Sequence[bool],
    lr: float,
    *,
    momentum: float,
    weight_decay: float,
) -> None:
    """One in-place Caffe2 momentum-SGD update of ``params`` and ``velocity``."""
    if not (len(params) == len(grads) == len(velocity) == len(is_bias)):
        raise ValueError("params, grads, velocity and is_bias differ in length")
    for bias in (False, True):
        sel = [i for i, b in enumerate(is_bias) if b == bias]
        if not sel:
            continue
        p = [params[i] for i in sel]
        g = [grads[i].float() for i in sel]
        v = [velocity[i] for i in sel]
        if bias:
            torch._foreach_mul_(g, 2.0)
        else:
            torch._foreach_add_(g, p, alpha=weight_decay)
        torch._foreach_mul_(g, lr)
        torch._foreach_mul_(v, momentum)
        torch._foreach_add_(v, g)
        torch._foreach_sub_(p, v)


@torch.no_grad()
def rescale_momentum(velocity: Dict[str, torch.Tensor], correction: float,
                     trainable: Dict[str, bool]) -> None:
    """V *= correction for trainable params, in place (detector.py:628-648)."""
    torch._foreach_mul_([v for k, v in velocity.items() if trainable[k]], correction)
