"""Pooling with torch-compatible semantics, NCHW.

Counterpart of ``deepipr_tpu/ops/pooling.py`` (max_pool2d,
adaptive_avg_pool2d, global_avg_pool).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """nn.MaxPool2d equivalent (floor mode), padding with -inf."""
    if padding:
        x = F.pad(x, (padding,) * 4, value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]
                        ) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d: output cell i averages rows
    [floor(i*H/out), ceil((i+1)*H/out)), and likewise columns, the JAX
    function's windows; windows overlap, or repeat a row, where out does
    not divide H (4 -> 6 repeats every other row). Accumulates in f32 and
    returns x's dtype, as ``jnp.mean`` does for bf16."""
    return F.adaptive_avg_pool2d(x.float(), out_hw).to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C), accumulated in f32."""
    return x.mean(dim=(2, 3), dtype=torch.float32)
