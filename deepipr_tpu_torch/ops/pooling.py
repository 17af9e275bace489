"""Pooling with torch-compatible semantics, NCHW.

Counterpart of ``deepipr_tpu/ops/pooling.py`` (max_pool2d, global_avg_pool).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """nn.MaxPool2d equivalent (floor mode), padding with -inf."""
    if padding:
        x = F.pad(x, (padding,) * 4, value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C), accumulated in f32."""
    return x.mean(dim=(2, 3), dtype=torch.float32)
