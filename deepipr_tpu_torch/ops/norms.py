"""Normalization layers matching the reference's norm-type choices, eval only.

Counterpart of ``deepipr_tpu/ops/norms.py``. The reference uses
(models/layers/conv2d.py:11-18, passportconv2d.py:56-64):

- 'bn': BatchNorm2d (affine for normal blocks, affine-free for passport blocks)
- 'gn': GroupNorm with C//16 groups
- 'in': InstanceNorm2d (affine-free, no running stats)
- 'none': identity

The JAX package keeps flax's BN conventions, which the port holds to once
training is ported (they do not touch the eval path here):

- W1: the running variance stores the *biased* batch variance (torch's
  ``nn.BatchNorm2d`` stores the unbiased one);
- W2: the running-stat EMA is ``running = 0.9*running + 0.1*batch``
  (flax momentum 0.9, torch's momentum 0.1). Epsilon is 1e-5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5


class BatchNorm(nn.Module):
    """Eval-mode BN over running statistics (``running_mean``/``running_var``).

    Train-mode statistics belong to the training slice; the module raises if
    asked to normalize in training mode rather than silently using the
    running stats.
    """

    def __init__(self, features: int, affine: bool = True, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def _require_eval(self) -> None:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call model.eval()")

    def running_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), for consumers that fuse the normalize (the epilogue)."""
        self._require_eval()
        return self.running_mean, self.running_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._require_eval()
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm; InstanceNorm is the one-channel-per-group case."""

    def __init__(self, num_groups: int, features: int, affine: bool,
                 eps: float = EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)


def make_norm(norm_type: str, features: int,
              affine: Optional[bool] = None) -> Optional[nn.Module]:
    """The norm submodule for a block; None for norm_type='none'.

    ``affine=None`` picks the torch default per norm type: BN/GN affine,
    InstanceNorm affine-free.
    """
    if norm_type == "bn":
        return BatchNorm(features, affine=True if affine is None else affine)
    if norm_type == "gn":
        if features % 16 != 0:
            raise ValueError(f"GroupNorm requires features % 16 == 0, got {features}")
        return GroupNorm(features // 16, features,
                         affine=True if affine is None else affine)
    if norm_type == "in":
        return GroupNorm(features, features,
                         affine=False if affine is None else affine)
    if norm_type == "none":
        return None
    raise ValueError(f"unknown norm type: {norm_type}")


def apply_norm(norm: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    return x if norm is None else norm(x)
