"""LR schedules and the SGD optimizer matching the reference recipes.

Counterpart of ``deepipr_tpu/train/schedule.py``. Reference:
SGD(momentum=0.9, weight_decay=1e-4) with MultiStepLR stepped per epoch
(experiments/classification.py:47-57). ``torch.optim.SGD`` adds the decay to
the gradient before the momentum buffer, the order of the JAX package's
``add_decayed_weights -> trace -> scale_by_learning_rate``.

W10: ``torch.optim.SGD`` skips a parameter whose ``.grad`` is None (no
decay, no momentum), where optax updates every leaf with a zero gradient.
``train/state.py`` gives every parameter a zero gradient before the first
step and zeroes rather than drops it after each, so the two agree.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def multistep_lr(base_lr: float, lr_config: Dict,
                 steps_per_epoch: int) -> Schedule:
    """MultiStepLR: lr *= gamma at each epoch boundary (from the boundary's
    first step on); the constant ``base_lr`` if there are no steps."""
    sched_type = lr_config.get("type", "steps")
    if sched_type != "steps":
        raise ValueError(
            f"unsupported lr schedule type {sched_type!r}: the reference "
            "lr_configs only define type='steps' (MultiStepLR)"
        )
    steps = lr_config.get("steps", [])
    if not steps:
        return base_lr
    boundaries = {int(e) * steps_per_epoch: lr_config["gamma"] for e in steps}

    def schedule(step: int) -> float:
        lr = base_lr
        for boundary, gamma in sorted(boundaries.items()):
            if step >= boundary:
                lr *= gamma
        return lr

    return schedule


def sgd_optimizer(params: Iterable[torch.nn.Parameter],
                  learning_rate: Schedule, momentum: float = 0.9,
                  weight_decay: float = 1e-4) -> torch.optim.SGD:
    """torch.optim.SGD with the reference's settings (no dampening, no
    nesterov). A schedule's value is set before each step by
    ``TrainState.apply_gradients``."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, dampening=0,
                           nesterov=False)
