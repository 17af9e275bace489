"""Train state: the model, its optimizer, the step counter and the schedule.

Counterpart of ``deepipr_tpu/train/state.py::TrainState``. The JAX state is
an immutable pytree of params, BN statistics, passports, signatures and the
optax state; here the model holds the params and the buffers (BN running
statistics, passports ``key``/``skey``, signatures ``b``), the optimizer
holds the momentum, and a step updates all of them in place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from deepipr_tpu_torch.train.schedule import Schedule, sgd_optimizer


class TrainState:
    """model, optimizer (``torch.optim.SGD``), step (a host int) and the
    learning-rate schedule (a float or a step -> lr function)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step
        # tensor parallelism (parallel/mesh.py::shard_model_parallel): the
        # parameters this rank holds a slice of, name -> sharded dim, and
        # the mesh they are sharded over
        self.model_sharded: Dict[str, int] = {}
        self.mesh = None

    @classmethod
    def create(cls, model: nn.Module, learning_rate: Schedule,
               momentum: float = 0.9, weight_decay: float = 1e-4
               ) -> "TrainState":
        """SGD over every parameter of ``model``, each given a zero gradient
        so that decay and momentum reach all of them, as optax's do (W10)."""
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt = sgd_optimizer(model.parameters(), learning_rate,
                            momentum=momentum, weight_decay=weight_decay)
        return cls(model, opt, learning_rate)

    def apply_gradients(self) -> None:
        """One SGD update at the schedule's rate for this step, from the
        parameters' gradients, which are then zeroed (not dropped, W10);
        advances the step counter."""
        s = self.schedule
        lr = s(self.step) if callable(s) else s
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=False)
        self.step += 1
