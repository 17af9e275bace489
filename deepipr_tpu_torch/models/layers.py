"""Layer blocks: ConvBlock, PassportBlock, PassportPrivateBlock (NCHW).

Counterpart of ``deepipr_tpu/models/layers.py`` (reference:
models/layers/conv2d.py, passportconv2d.py, passportconv2d_private.py).

- Every block's ``forward(x, ind=0, force_passport=False)`` returns
  ``(y, aux)``. ``aux`` is None, or the dict {'scale','bias','b','alpha'} of
  the affine derived from the passports: the counterpart of the JAX
  ``passport_aux`` sow, returned rather than stored on the module.
- Passports ``key``/``skey`` (1, C_in, H, W) and the signature ``b`` (C,) are
  buffers; the public ``scale``/``bias`` are parameters.
- The input, key and skey share one convolution (passport/derive.py).
- In eval mode with BN, the derived-affine path ends in the fused epilogue
  (ops/passport_epilogue.py), as ``layers.py:164-176`` of the JAX package
  does. Train mode (batch-statistic BN) and GN/IN/none take the plain path:
  norm, derived affine, ReLU, as there.
- ``dtype`` (None or torch.bfloat16) is the compute dtype, as in JAX: the
  convolution and the normalize path run in it and the block returns it;
  weights, BN statistics, passports and signatures stay f32, and the
  derived or learned scale/bias is cast to the activations' dtype just
  before the affine (``layers.py:88-98, 181-184, 229-232, 308-311``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

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
    y = (scale.to(y.dtype).view(1, -1, 1, 1) * y
         + bias.to(y.dtype).view(1, -1, 1, 1))
    return F.relu(y) if relu else y


def _out(y: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return y if dtype is None else y.to(dtype)


class ConvBlock(nn.Module):
    """Conv2d -> norm -> optional ReLU (reference: models/layers/conv2d.py:5-36).

    Conv bias exists only when norm_type == 'none', like the reference.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 1, norm_type: str = "bn",
                 relu: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.conv = Conv2D(in_channels, features, kernel_size, strides,
                           padding, use_bias=norm_type == "none", dtype=dtype)
        self.bn = make_norm(norm_type, features)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        y = apply_norm(self.bn, self.conv(x))
        return _out(F.relu(y) if self.relu else y, self.dtype), None


class _PassportBase(nn.Module):
    """Shared passport machinery for the V1 and V2/V3 passport blocks.

    ``input_hw`` is the spatial size of the block's input: the passports
    are shaped like a batch-1 slice of it, as the JAX blocks shape them
    from the first input they see.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 strides: int, padding: int, key_type: str, alpha: float,
                 b_spec: Union[None, int, str], relu: bool,
                 input_hw: Tuple[int, int], dtype: Optional[torch.dtype]):
        super().__init__()
        self.features = features
        self.key_type = key_type
        self.alpha = alpha
        self.b_spec = b_spec
        self.relu = relu
        self.dtype = dtype
        self.conv = Conv2D(in_channels, features, kernel_size, strides,
                           padding, use_bias=False, dtype=dtype)
        self.register_buffer("key", torch.zeros(1, in_channels, *input_hw))
        self.register_buffer("skey", torch.zeros(1, in_channels, *input_hw))
        self.register_buffer("b", torch.ones(features))

    def _derived_affine_forward(self, x, norm) -> Tuple[torch.Tensor, Aux]:
        """conv([x; key; skey]) -> derived (scale, bias) -> norm -> affine
        (-> ReLU); returns the output and the derived-affine aux."""
        y, key_out, skey_out = fused_conv_passport_outputs(
            x, self.key, self.skey, self.conv)
        if isinstance(norm, BatchNorm) and not norm.training:
            mean, var = norm.running_stats()
            y, scale, bias = passport_epilogue(
                y, key_out, skey_out, mean, var, eps=norm.eps, relu=self.relu)
        else:
            scale = gap_channel_mean(skey_out)
            bias = gap_channel_mean(key_out)
            y = _affine(apply_norm(norm, y), scale, bias, self.relu)
        y = _out(y, self.dtype)
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
                 input_hw: Tuple[int, int] = (32, 32),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, kernel_size, strides, padding,
                         key_type, alpha, b_spec, relu, input_hw, dtype)
        self.learnable_affine = learnable_affine
        self.bn = make_norm(norm_type, features, affine=False)
        if learnable_affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        if self.learnable_affine and not force_passport:
            y = apply_norm(self.bn, self.conv(x))
            return _out(_affine(y, self.scale, self.bias, self.relu),
                        self.dtype), None
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
                 input_hw: Tuple[int, int] = (32, 32),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, kernel_size, strides, padding,
                         key_type, alpha, b_spec, relu, input_hw, dtype)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn = make_norm(norm_type, features, affine=False)
        self.bn_private = None
        if separate_stats and norm_type == "bn":
            self.bn_private = make_norm(norm_type, features, affine=False)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        if ind == 0 and not force_passport:
            y = apply_norm(self.bn, self.conv(x))
            return _out(_affine(y, self.scale, self.bias, self.relu),
                        self.dtype), None
        norm = self.bn if self.bn_private is None else self.bn_private
        return self._derived_affine_forward(x, norm)


class ModelOutput(NamedTuple):
    """logits (N, classes); aux {module path: derived affine}, the
    counterpart of the JAX 'passport_aux' collection; tap, the input of the
    ``tap_at`` unit (None unless asked for)."""

    logits: torch.Tensor
    aux: Dict[str, Dict[str, Any]]
    tap: Optional[torch.Tensor]


def conv_out_hw(hw: Tuple[int, int], k: int, s: int,
                p: int) -> Tuple[int, int]:
    """Spatial size after a convolution or pooling window of size k,
    stride s and padding p (floor mode)."""
    return tuple((d + 2 * p - k) // s + 1 for d in hw)


def make_block(layer_kwargs: Optional[Dict[str, Any]], norm_type: str,
               in_channels: int, features: int, k: int, s: int, p: int,
               private: bool, relu: bool, input_hw: Tuple[int, int],
               dtype: Optional[torch.dtype]):
    """ConvBlock, or the passport block of the scheme where the layer's
    passport kwargs set ``flag``."""
    if layer_kwargs is not None and layer_kwargs["flag"]:
        common = dict(
            in_channels=in_channels,
            features=features,
            kernel_size=k,
            strides=s,
            padding=p,
            norm_type=layer_kwargs["norm_type"],
            key_type=layer_kwargs["key_type"],
            alpha=layer_kwargs["sign_loss"],
            b_spec=layer_kwargs.get("b"),
            relu=relu,
            input_hw=input_hw,
            dtype=dtype,
        )
        if private:
            return PassportPrivateBlock(
                separate_stats=layer_kwargs.get("separate_stats", False),
                **common)
        return PassportBlock(
            learnable_affine=layer_kwargs.get("learnable_affine", False),
            **common)
    nt = layer_kwargs["norm_type"] if layer_kwargs is not None else norm_type
    return ConvBlock(in_channels, features, k, s, p, norm_type=nt, relu=relu,
                     dtype=dtype)


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
