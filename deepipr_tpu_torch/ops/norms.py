"""Normalization layers matching the reference's norm-type choices.

Counterpart of ``deepipr_tpu/ops/norms.py``. The reference uses
(models/layers/conv2d.py:11-18, passportconv2d.py:56-64):

- 'bn': BatchNorm2d (affine for normal blocks, affine-free for passport blocks)
- 'gn': GroupNorm with C//16 groups
- 'in': InstanceNorm2d (affine-free, no running stats)
- 'none': identity

Train-mode BN holds to the JAX package's (flax's) conventions:

- W1: the running variance stores the *biased* batch variance (torch's
  ``nn.BatchNorm2d`` stores the unbiased one);
- W2: the running-stat EMA is ``running = 0.9*running + 0.1*batch``
  (flax momentum 0.9, torch's momentum 0.1). Epsilon is 1e-5.

Under bf16 (flax's ``BatchNorm(dtype=bf16)`` and ``GroupNorm(dtype=bf16)``)
a norm takes the block's bf16 activations and returns bf16: statistics,
running buffers and affine parameters stay f32, and the normalize runs in
f32 and is rounded once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
# running = BN_MOMENTUM*running + (1-BN_MOMENTUM)*batch; the split dual
# forward re-applies this EMA for prefix units (train/steps.py)
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BN over (N, H, W) per channel, with ``running_mean``/``running_var``.

    Eval mode normalizes with the running statistics. Train mode normalizes
    with the batch's mean and biased variance and folds both into the
    running statistics (W1, W2), in place.
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
            # an f32 identity affine for bf16 inputs: with f32 parameters
            # F.batch_norm normalizes a bf16 input in f32 and rounds once
            self.register_buffer("unit_weight", torch.ones(features),
                                 persistent=False)
            self.register_buffer("unit_bias", torch.zeros(features),
                                 persistent=False)

    def running_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var), for consumers that fuse the normalize (the epilogue);
        eval mode only, since train mode normalizes with batch statistics."""
        if self.training:
            raise RuntimeError("running_stats() is for eval mode; train-mode "
                               "BN normalizes with batch statistics")
        return self.running_mean, self.running_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if weight is None and x.dtype != torch.float32:
            weight, bias = self.unit_weight, self.unit_bias
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, False, 0.0, self.eps)
        # the running buffers stay out of F.batch_norm, which would store the
        # unbiased variance (W1); the statistics are taken in f32
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3),
                                       correction=0)
            for buf, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
                buf.mul_(BN_MOMENTUM).add_(batch, alpha=1.0 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, self.eps)


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
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


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
