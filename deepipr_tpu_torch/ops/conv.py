"""Conv2D: NCHW convolution with an OIHW weight and a compute dtype.

Counterpart of ``deepipr_tpu/ops/conv.py``. The input and weight are cast to
the compute dtype (None keeps the input's), and the output stays in it; the
calling block works in f32 after the conv. Only f32 runs in this slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2D(nn.Module):
    """Square-kernel conv; ``weight`` is (out, in, k, k), ``bias`` optional."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 strides: int = 1, padding: int = 0, use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.strides = strides
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compute = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(compute)
        return F.conv2d(x.to(compute), self.weight.to(compute), bias,
                        stride=self.strides, padding=self.padding)
