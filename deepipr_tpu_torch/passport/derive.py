"""Passport -> affine derivation: scale/bias from key conv + global average pool.

Counterpart of ``deepipr_tpu/passport/derive.py``, in NCHW. Reference
semantics (models/layers/passportconv2d.py:142-175):

    scale_c = mean_batch(mean_spatial(conv(skey)[:, c]))
    bias_c  = mean_batch(mean_spatial(conv(key)[:, c]))

The input, key and skey share one convolution kernel, so the three
convolutions run as one over the rows ``[x; key; skey]``. Under bf16 the
passports are cast to ``x.dtype`` for that convolution and their outputs
back to f32, so the GAP and the derived scale/bias are f32 (W5).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

ConvFn = Callable[[torch.Tensor], torch.Tensor]


def gap_channel_mean(y: torch.Tensor) -> torch.Tensor:
    """Global average pool + batch mean: (N, C, H, W) -> (C,)."""
    return y.mean(dim=(0, 2, 3))


def derive_affine(
    conv_fn: ConvFn, key: torch.Tensor, skey: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) derived from passports through the layer's own convolution.

    scale comes from skey, bias from key (passportconv2d.py:148-175).
    """
    scale = gap_channel_mean(conv_fn(skey))
    bias = gap_channel_mean(conv_fn(key))
    return scale, bias


def fused_conv_passport_outputs(
    x: torch.Tensor, key: torch.Tensor, skey: torch.Tensor, conv_fn: ConvFn
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One convolution over ``[x; key; skey]``; raw per-row outputs.

    Returns (y, key_out, skey_out): y = conv(x) of shape (N, C, H', W') in the
    compute dtype, key_out/skey_out = conv over the passports, shape
    (Bk, C, H', W'), always f32 so signature signs stay robust under mixed
    precision.
    """
    n = x.shape[0]
    bk = key.shape[0]
    out = conv_fn(torch.cat([x, key.to(x.dtype), skey.to(x.dtype)], dim=0))
    return (
        out[:n],
        out[n : n + bk].to(torch.float32),
        out[n + bk :].to(torch.float32),
    )
