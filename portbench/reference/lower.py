"""Convolutions and matmuls with their operands rounded to a lower precision.

The control of the comparison that decides ``correct``: the reference put in
the program's place, one precision below the one the configuration states.
A tensor core multiplies operands held in the lower format and accumulates
in float32; here the operands (input, weight, and in the backward the
incoming gradient) are rounded to that format and the products are taken in
float32 from the rounded values, which is the same arithmetic, on the CPU
and on the card alike.

- ``TF32`` (below float32): round to nearest even to 10 mantissa bits.
- ``FP8`` (below bfloat16): each tensor scaled so that its largest magnitude
  meets the format's largest finite value, then cast, as a per-tensor scaled
  FP8 matmul takes it: E4M3 for inputs and weights, E5M2 for gradients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

Round = Callable[[torch.Tensor], torch.Tensor]


class Lower(NamedTuple):
    name: str
    act: Round
    weight: Round
    grad: Round


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float32 with a 10-bit mantissa (ties to
    even)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def _scaled_cast(dtype: torch.dtype) -> Round:
    top = torch.finfo(dtype).max

    def cast(x: torch.Tensor) -> torch.Tensor:
        scale = top / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(dtype).to(torch.float32) / scale

    return cast


TF32 = Lower("tf32", round_tf32, round_tf32, round_tf32)
FP8 = Lower("fp8", _scaled_cast(torch.float8_e4m3fn),
            _scaled_cast(torch.float8_e4m3fn), _scaled_cast(torch.float8_e5m2))

BELOW = {"float32": TF32, "bfloat16": FP8}


class _LowConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pad, lower):
        xq, wq = lower.act(x), lower.weight(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.pad, ctx.lower = stride, pad, lower
        return F.conv2d(xq, wq, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.lower.grad(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride,
                                            ctx.pad)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride,
                                             ctx.pad)
        return dx, dw, None, None, None


class _LowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, lower):
        xq, wq = lower.act(x), lower.weight(w)
        ctx.save_for_backward(xq, wq)
        ctx.lower = lower
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.lower.grad(g)
        return gq @ wq, gq.t() @ xq, None


def low_conv2d(x, w, stride: int, pad: int, lower: Lower) -> torch.Tensor:
    return _LowConv.apply(x, w, stride, pad, lower)


def low_linear(x, w, b, lower: Lower) -> torch.Tensor:
    return _LowLinear.apply(x, w, lower) + b
