"""Learning-rate schedules (ref: detectron/lib/utils/lr_policy.py:28-108).

A copy of sad_tpu/train/lr_policy.py. Pure functions of the iteration,
computed on the host and handed to the train step as a Python float, as
the reference feeds the 'lr' blob each iteration (train_net.py:167).
"""

from __future__ import annotations

import numpy as np

from ..config import SolverConfig


def _step_index(solver: SolverConfig, cur_iter: int) -> int:
    steps = list(solver.STEPS) + [solver.MAX_ITER]
    if steps[0] != 0:
        raise ValueError("SOLVER.STEPS must start at 0")
    # Loop-fallthrough mirrors the reference's get_step_index: at or past
    # MAX_ITER, ind stays at the last enumerate value (len(steps)-1).
    ind = len(steps) - 1
    for ind, step in enumerate(steps):
        if cur_iter < step:
            break
    return ind - 1


def _base_lr_at(solver: SolverConfig, cur_iter: int) -> float:
    policy = solver.LR_POLICY
    if policy == "steps_with_decay":
        return solver.BASE_LR * solver.GAMMA ** _step_index(solver, cur_iter)
    if policy == "steps_with_lrs":
        return solver.LRS[_step_index(solver, cur_iter)]
    if policy == "step":
        return solver.BASE_LR * solver.GAMMA ** (cur_iter // solver.STEP_SIZE)
    raise NotImplementedError(f"Unknown LR policy: {policy}")


def get_lr_at_iter(solver: SolverConfig, it: int) -> float:
    """Scheduled LR with warmup (lr_policy.py:28-44)."""
    lr = _base_lr_at(solver, it)
    if it < solver.WARM_UP_ITERS:
        method = solver.WARM_UP_METHOD
        if method == "constant":
            factor = solver.WARM_UP_FACTOR
        elif method == "linear":
            alpha = it / solver.WARM_UP_ITERS
            factor = solver.WARM_UP_FACTOR * (1 - alpha) + alpha
        else:
            raise KeyError(f"Unknown SOLVER.WARM_UP_METHOD: {method}")
        lr *= factor
    return float(np.float32(lr))


def lr_change_correction(solver: SolverConfig, cur_lr: float, new_lr: float):
    """Momentum-history rescale factor on LR change, or None.

    The reference rescales V by new_lr/cur_lr when the change ratio exceeds
    SCALE_MOMENTUM_THRESHOLD (detector.py:616-648), because the Caffe2 update
    V := mu*V + lr*g folds lr into the history."""
    if cur_lr == new_lr or not solver.SCALE_MOMENTUM or cur_lr <= 1e-7:
        return None
    eps = 1e-10
    ratio = max((cur_lr + eps) / (new_lr + eps), (new_lr + eps) / (cur_lr + eps))
    if ratio > solver.SCALE_MOMENTUM_THRESHOLD:
        return new_lr / cur_lr
    return None
