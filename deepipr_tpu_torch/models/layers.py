"""Layer blocks: ConvBlock, PassportBlock, PassportPrivateBlock (NCHW, eval).

Counterpart of ``deepipr_tpu/models/layers.py`` (reference:
models/layers/conv2d.py, passportconv2d.py, passportconv2d_private.py).

- Every block's ``forward(x, ind=0, force_passport=False)`` returns
  ``(y, aux)``. ``aux`` is None, or the dict {'scale','bias','b','alpha'} of
  the affine derived from the passports: the counterpart of the JAX
  ``passport_aux`` sow, returned rather than stored on the module.
- Passports ``key``/``skey`` (1, C_in, H, W) and the signature ``b`` (C,) are
  buffers; the public ``scale``/``bias`` are parameters.
- The input, key and skey share one convolution (passport/derive.py).
- With BN, the derived-affine path ends in the fused epilogue
  (ops/passport_epilogue.py), as ``layers.py:164-176`` of the JAX package
  does; GN/IN/none use the plain path, as there.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from deepipr_tpu_torch.ops.conv import Conv2D
from deepipr_tpu_torch.ops.norms import BatchNorm, apply_norm, make_norm
from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue
from deepipr_tpu_torch.passport.codec import encode_signature
from deepipr_tpu_torch.passport.derive import (
    fused_conv_passport_outputs,
    gap_channel_mean,
)

Aux = Optional[Dict[str, object]]


def _affine(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            relu: bool) -> torch.Tensor:
    y = scale.view(1, -1, 1, 1) * y + bias.view(1, -1, 1, 1)
    return F.relu(y) if relu else y


class ConvBlock(nn.Module):
    """Conv2d -> norm -> optional ReLU (reference: models/layers/conv2d.py:5-36).

    Conv bias exists only when norm_type == 'none', like the reference.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 1, norm_type: str = "bn",
                 relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = Conv2D(in_channels, features, kernel_size, strides,
                           padding, use_bias=norm_type == "none")
        self.bn = make_norm(norm_type, features)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        y = apply_norm(self.bn, self.conv(x))
        return (F.relu(y) if self.relu else y), None


class _PassportBase(nn.Module):
    """Shared passport machinery for the V1 and V2/V3 passport blocks.

    ``input_hw`` is the spatial size of the block's input: the passports
    are shaped like a batch-1 slice of it, as the JAX blocks shape them
    from the first input they see.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 strides: int, padding: int, key_type: str, alpha: float,
                 b_spec: Union[None, int, str], relu: bool,
                 input_hw: Tuple[int, int]):
        super().__init__()
        self.features = features
        self.key_type = key_type
        self.alpha = alpha
        self.b_spec = b_spec
        self.relu = relu
        self.conv = Conv2D(in_channels, features, kernel_size, strides,
                           padding, use_bias=False)
        self.register_buffer("key", torch.zeros(1, in_channels, *input_hw))
        self.register_buffer("skey", torch.zeros(1, in_channels, *input_hw))
        self.register_buffer("b", torch.ones(features))

    def _derived_affine_forward(self, x, norm) -> Tuple[torch.Tensor, Aux]:
        """conv([x; key; skey]) -> derived (scale, bias) -> norm -> affine
        (-> ReLU); returns the output and the derived-affine aux."""
        y, key_out, skey_out = fused_conv_passport_outputs(
            x, self.key, self.skey, self.conv)
        if isinstance(norm, BatchNorm):
            mean, var = norm.running_stats()
            y, scale, bias = passport_epilogue(
                y, key_out, skey_out, mean, var, eps=norm.eps, relu=self.relu)
        else:
            scale = gap_channel_mean(skey_out)
            bias = gap_channel_mean(key_out)
            y = _affine(apply_norm(norm, y), scale, bias, self.relu)
        if self.alpha == 0:
            return y, None
        return y, {"scale": scale, "bias": bias, "b": self.b,
                   "alpha": self.alpha}


class PassportBlock(_PassportBase):
    """V1 passport layer (reference: models/layers/passportconv2d.py:11-223).

    conv (no bias) -> affine-free norm -> scale*x + bias -> optional ReLU,
    with (scale, bias) derived from the passports through the layer's own
    convolution. With ``learnable_affine=True`` learned scale/bias
    parameters exist and are used unless ``force_passport``.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 1, norm_type: str = "bn",
                 key_type: str = "random", alpha: float = 1.0,
                 b_spec: Union[None, int, str] = None, relu: bool = True,
                 learnable_affine: bool = False,
                 input_hw: Tuple[int, int] = (32, 32)):
        super().__init__(in_channels, features, kernel_size, strides, padding,
                         key_type, alpha, b_spec, relu, input_hw)
        self.learnable_affine = learnable_affine
        self.bn = make_norm(norm_type, features, affine=False)
        if learnable_affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        if self.learnable_affine and not force_passport:
            y = apply_norm(self.bn, self.conv(x))
            return _affine(y, self.scale, self.bias, self.relu), None
        return self._derived_affine_forward(x, self.bn)


class PassportPrivateBlock(_PassportBase):
    """V2/V3 dual-branch passport layer
    (reference: models/layers/passportconv2d_private.py:11-219).

    ind=0 (public/deployment): learned scale/bias parameters.
    ind=1 (private/verification): scale/bias derived from the passports.
    One shared conv and, by default, one shared affine-free norm serve both
    branches; ``separate_stats=True`` gives the private branch its own BN
    statistics (``bn_private``).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 1, norm_type: str = "bn",
                 key_type: str = "random", alpha: float = 1.0,
                 b_spec: Union[None, int, str] = None,
                 separate_stats: bool = False, relu: bool = True,
                 input_hw: Tuple[int, int] = (32, 32)):
        super().__init__(in_channels, features, kernel_size, strides, padding,
                         key_type, alpha, b_spec, relu, input_hw)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn = make_norm(norm_type, features, affine=False)
        self.bn_private = None
        if separate_stats and norm_type == "bn":
            self.bn_private = make_norm(norm_type, features, affine=False)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        if ind == 0 and not force_passport:
            y = apply_norm(self.bn, self.conv(x))
            return _affine(y, self.scale, self.bias, self.relu), None
        norm = self.bn if self.bn_private is None else self.bn_private
        return self._derived_affine_forward(x, norm)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights, passports and signatures drawn from ``generator``.

    Conv: kaiming normal, fan_out, ReLU gain (the reference's init,
    conv2d.py:28). Linear: normal with variance 1/fan_in (flax Dense's
    lecun-normal scale, untruncated), zero bias. Passports: U(-1, 1), as
    random passports are drawn (layers.py:122-125 of the JAX package).
    Signatures: ``encode_signature`` with the block's ``b_spec``. BN stats
    and learned affines keep their identity values. Works on CPU tensors.
    """
    for m in model.modules():
        if isinstance(m, Conv2D):
            fan_out = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]),
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, _PassportBase):
            m.key.uniform_(-1.0, 1.0, generator=generator)
            m.skey.uniform_(-1.0, 1.0, generator=generator)
            m.b.copy_(encode_signature(generator, m.features, m.b_spec))
