"""Inference folding: collapse BN and affine chains into conv kernels.

Counterpart of ``deepipr_tpu/interop/fold.py``. At eval time every block of
the zoo is ``conv -> per-channel affine chain -> (ReLU)``: BN with running
statistics, the passport-derived scale/bias and the learned public
scale/bias are affines; they compose, and an affine after a convolution
folds into it:

    s*r*(conv(x) + b0 - m) + b  ==  conv'(x) + B
    with  conv'.weight = weight * A,  A = s*r,  r = rsqrt(var + eps),
          B = A*(b0 - m) + b

so the folded model is the normal architecture with norm_type='none' (conv
+ bias + ReLU): no normalization and no K2 at run time, and the deployment
artifact: no passports, no signatures and no BN statistics in its state
dict (reference README.md:40-61).

Folding takes norm_type 'bn' and 'none' models; GroupNorm and InstanceNorm
normalize per sample at eval and cannot be folded.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepipr_tpu_torch.attacks.common import derived_affines, jax_path
from deepipr_tpu_torch.models.alexnet import AlexNet
from deepipr_tpu_torch.models.layers import (
    ConvBlock,
    PassportBlock,
    PassportPrivateBlock,
)
from deepipr_tpu_torch.models.resnet import ResNet
from deepipr_tpu_torch.ops.norms import BatchNorm
from deepipr_tpu_torch.utils.device import model_device


def _build_normal_none(model):
    """The normal architecture of ``model`` with norm_type='none', on its
    device, of its dtype and head."""
    if isinstance(model, AlexNet):
        folded = AlexNet(num_classes=model.num_classes,
                         in_channels=model.in_channels, norm_type="none",
                         imagenet=model.head_imagenet,
                         input_size=model.input_size, dtype=model.dtype)
    elif isinstance(model, ResNet):
        folded = ResNet(model.block_cls, model.num_blocks,
                        num_classes=model.num_classes, norm_type="none",
                        imagenet=model.is_imagenet,
                        input_size=model.input_size, dtype=model.dtype)
    else:
        raise TypeError(f"cannot fold model of type {type(model).__name__}")
    return folded.to(model_device(model))


def _affine(block, name: str, ind: int, private: bool,
            derived: Dict[str, Dict]) -> Optional[Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """(s, b) of the block's affine for branch ``ind``, as the JAX package
    picks it (fold.py:112-129); None for a plain conv."""
    if isinstance(block, ConvBlock):
        bn = block.bn
        if isinstance(bn, BatchNorm) and bn.weight is not None:
            return bn.weight, bn.bias
        return None
    aux = derived.get(jax_path(name))
    if private and ind == 1 and aux is not None:
        return aux["scale"].reshape(-1), aux["bias"].reshape(-1)
    if hasattr(block, "scale"):  # V2 public branch, V1 learnable_affine
        return block.scale, block.bias
    if aux is not None:  # standard V1: always derived
        return aux["scale"].reshape(-1), aux["bias"].reshape(-1)
    return None


@torch.no_grad()
def fold_for_inference(model, input_shape=None, ind: int = 0):
    """A new norm_type='none' model of the same family, head, dtype and
    device whose forward is branch ``ind`` of ``model`` in eval mode.

    ind=0 folds the public/deployment branch (learned affines); ind=1 the
    private/verification branch (passport-derived affines, and the private
    BN statistics of a separate-stats model). Normal models fold their BN
    affine. ``input_shape`` (NHWC) shapes the zeros batch the passport
    affines are derived with; by default (1, side, side, 3) at the model's
    own input side. ``model`` is not modified.

    A bf16 folded model runs slower than the unfolded one at large batches:
    its conv biases are added in f32 (norm type 'none', as in the JAX
    package), then ReLU and the cast back to bf16 follow as separate
    passes (PERF.md section 5).
    """
    norm_type = getattr(model, "norm_type", "bn")
    if norm_type not in ("bn", "none"):
        raise ValueError(
            f"fold_for_inference supports norm_type 'bn'/'none', got "
            f"{norm_type!r} (GN/IN normalize per sample at eval)")
    private = bool(getattr(model, "private", False))
    derived: Dict[str, Dict] = {}
    if getattr(model, "passport_kwargs", None) is not None:
        if input_shape is None:
            input_shape = (1, model.input_size, model.input_size, 3)
        derived = derived_affines(model, input_shape, private)

    folded = _build_normal_none(model)
    out = folded.state_dict()
    for name, target in folded.named_modules():
        if not isinstance(target, ConvBlock):
            continue
        block = model.get_submodule(name)
        if not isinstance(block, (ConvBlock, PassportBlock,
                                  PassportPrivateBlock)):
            raise TypeError(f"{name}: cannot fold a {type(block).__name__}")
        weight = block.conv.weight.float()
        c = weight.shape[0]
        b0 = (block.conv.bias.float() if block.conv.bias is not None
              else torch.zeros(c, device=weight.device))
        bn = block.bn
        if ind == 1 and getattr(block, "bn_private", None) is not None:
            bn = block.bn_private
        affine = _affine(block, name, ind, private, derived)
        s, b = ((torch.ones_like(b0), torch.zeros_like(b0)) if affine is None
                else (affine[0].float(), affine[1].float()))
        if isinstance(bn, BatchNorm):
            a = s * torch.rsqrt(bn.running_var.float() + bn.eps)
            bias = a * (b0 - bn.running_mean.float()) + b
        else:
            a, bias = s, s * b0 + b
        out[f"{name}.conv.weight"] = weight * a.view(-1, 1, 1, 1)
        out[f"{name}.conv.bias"] = bias
    for name, value in model.state_dict().items():
        if name.split(".")[0].startswith(("linear", "classifier")):
            out[name] = value  # the dense head copies through
    folded.load_state_dict(out, strict=True)
    return folded
