"""ResNet family: normal / V1 passport / V2-V3 private passport (NCHW).

Counterpart of ``deepipr_tpu/models/resnet.py``; topology matches the
reference (models/resnet_normal.py, resnet_passport.py,
resnet_passport_private.py), quirks included:

- BasicBlock: convbnrelu_1 -> convbn_2 (the reference applies ReLU inside
  convbn_2 as well, resnet_normal.py:16) -> + shortcut(x) -> ReLU; the
  shortcut ConvBlock also carries a ReLU (resnet_normal.py:19-20).
- Bottleneck: 1x1 -> 3x3 (the stride, torchvision's layout) -> 1x1 (no
  ReLU) + shortcut (no ReLU) -> ReLU. Passport positions are the JAX
  package's extension beyond the reference (``resnet.py:123-172``):
  convbn_3 and shortcut keep relu=False in every scheme, so the fused
  epilogue (K2) and its gradient run without their ReLU there.
- CIFAR stem: 3x3 s1; ImageNet stem: 7x7 s2 + MaxPool(3, 2, 1).
- Per-sub-block passport flags via nested passport_kwargs
  (layerN -> block idx -> convbnrelu_1/convbn_2/shortcut, or
  convbnrelu_1/convbnrelu_2/convbn_3/shortcut in a Bottleneck).

Module names follow the JAX module paths (``layer4_0.convbnrelu_1``), so a
JAX variable tree maps onto the state dict by path (interop/jax_params.py).
``dtype`` (None or torch.bfloat16) is every block's compute dtype; the
global average pool returns f32 and the ``linear`` head runs in f32, so
logits and losses are f32 (``resnet.py:237-238``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepipr_tpu_torch.models.layers import (
    ModelOutput,
    conv_out_hw,
    init_weights,
    make_block,
    run_unit,
)
from deepipr_tpu_torch.ops.pooling import global_avg_pool, max_pool2d


class BasicBlock(nn.Module):
    """Residual basic block; passport_kwargs maps sub-block name -> layer kwargs."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 norm_type: str = "bn",
                 passport_kwargs: Optional[Dict[str, Any]] = None,
                 private: bool = False,
                 input_hw: Tuple[int, int] = (32, 32),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def sub(name):
            return None if passport_kwargs is None else passport_kwargs[name]

        mid_hw = conv_out_hw(input_hw, 3, stride, 1)
        self.output_hw = mid_hw
        self.convbnrelu_1 = make_block(sub("convbnrelu_1"), norm_type,
                                       in_planes, planes, 3, stride, 1,
                                       private, True, input_hw, dtype)
        self.convbn_2 = make_block(sub("convbn_2"), norm_type, planes,
                                   planes, 3, 1, 1, private, True, mid_hw,
                                   dtype)
        self.shortcut = None
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = make_block(sub("shortcut"), norm_type, in_planes,
                                       self.expansion * planes, 1, stride, 0,
                                       private, True, input_hw, dtype)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        aux = {}
        out, aux["convbnrelu_1"] = self.convbnrelu_1(x, ind, force_passport)
        out, aux["convbn_2"] = self.convbn_2(out, ind, force_passport)
        if self.shortcut is not None:
            sc, aux["shortcut"] = self.shortcut(x, ind, force_passport)
            out = out + sc
        else:
            out = out + x
        return F.relu(out), {k: v for k, v in aux.items() if v is not None}


class Bottleneck(nn.Module):
    """Bottleneck block; passport_kwargs maps sub-block name -> layer
    kwargs. A config may leave out ``shortcut`` (or any sub-block): that
    position is then a plain ConvBlock in the model's norm, as the JAX
    Bottleneck reads its sub-kwargs with ``.get`` (``resnet.py:141-143``).
    Sub-blocks run, and their aux comes out, in the JAX call order:
    convbnrelu_1, convbnrelu_2, convbn_3, shortcut."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 norm_type: str = "bn",
                 passport_kwargs: Optional[Dict[str, Any]] = None,
                 private: bool = False,
                 input_hw: Tuple[int, int] = (32, 32),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def sub(name):
            return None if passport_kwargs is None else passport_kwargs.get(
                name)

        out_planes = self.expansion * planes
        out_hw = conv_out_hw(input_hw, 3, stride, 1)
        self.output_hw = out_hw
        self.convbnrelu_1 = make_block(sub("convbnrelu_1"), norm_type,
                                       in_planes, planes, 1, 1, 0, private,
                                       True, input_hw, dtype)
        self.convbnrelu_2 = make_block(sub("convbnrelu_2"), norm_type,
                                       planes, planes, 3, stride, 1, private,
                                       True, input_hw, dtype)
        self.convbn_3 = make_block(sub("convbn_3"), norm_type, planes,
                                   out_planes, 1, 1, 0, private, False,
                                   out_hw, dtype)
        self.shortcut = None
        if stride != 1 or in_planes != out_planes:
            self.shortcut = make_block(sub("shortcut"), norm_type, in_planes,
                                       out_planes, 1, stride, 0, private,
                                       False, input_hw, dtype)

    def forward(self, x, ind: int = 0, force_passport: bool = False):
        aux = {}
        out, aux["convbnrelu_1"] = self.convbnrelu_1(x, ind, force_passport)
        out, aux["convbnrelu_2"] = self.convbnrelu_2(out, ind, force_passport)
        out, aux["convbn_3"] = self.convbn_3(out, ind, force_passport)
        if self.shortcut is not None:
            sc, aux["shortcut"] = self.shortcut(x, ind, force_passport)
            out = out + sc
        else:
            out = out + x
        return F.relu(out), {k: v for k, v in aux.items() if v is not None}


class ResNet(nn.Module):
    """Generic ResNet; passport_kwargs=None gives the normal model.

    ``input_size`` is the image side the passports are shaped for (32 for
    CIFAR); ``seed`` seeds the random weights (layers.init_weights);
    ``dtype`` is the blocks' compute dtype (None: f32).
    """

    def __init__(self, block_cls: type, num_blocks: Sequence[int],
                 num_classes: int = 10, norm_type: str = "bn",
                 passport_kwargs: Optional[Dict[str, Any]] = None,
                 private: bool = False, imagenet: bool = False,
                 input_size: int = 32, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block_cls = block_cls
        self.num_blocks = tuple(num_blocks)
        self.num_classes = num_classes
        self.norm_type = norm_type
        self.input_size = input_size
        self.passport_kwargs = passport_kwargs
        self.private = private
        self.dtype = dtype
        self.is_imagenet = imagenet or num_classes == 1000
        pk = passport_kwargs

        hw = (input_size, input_size)
        stem_kwargs = None if pk is None else pk["convbnrelu_1"]
        k, s, p = (7, 2, 3) if self.is_imagenet else (3, 1, 1)
        self.convbnrelu_1 = make_block(stem_kwargs, norm_type, 3, 64, k, s,
                                       p, private, True, hw, dtype)
        hw = conv_out_hw(hw, k, s, p)
        if self.is_imagenet:
            hw = conv_out_hw(hw, 3, 2, 1)
        self.unit_names: List[str] = ["convbnrelu_1"]

        in_planes = 64
        for li, (planes, n, stride) in enumerate(
            zip((64, 128, 256, 512), self.num_blocks, (1, 2, 2, 2)), start=1
        ):
            layer_pk = None if pk is None else pk[f"layer{li}"]
            for bi, st in enumerate([stride] + [1] * (n - 1)):
                name = f"layer{li}_{bi}"
                blk = block_cls(
                    in_planes, planes, st, norm_type,
                    None if layer_pk is None else layer_pk[str(bi)],
                    private, hw, dtype,
                )
                self.add_module(name, blk)
                self.unit_names.append(name)
                hw = blk.output_hw
                in_planes = planes * block_cls.expansion

        self.linear = nn.Linear(512 * block_cls.expansion, num_classes)
        init_weights(self, torch.Generator().manual_seed(seed))
        # built for inference; the train step switches to train mode, and
        # every eval entry point enters eval mode itself (utils/mode.py)
        self.eval()

    def forward(self, x, ind: int = 0, force_passport: bool = False,
                start_at: Optional[str] = None,
                tap_at: Optional[str] = None,
                remat: bool = False) -> ModelOutput:
        """x: NCHW images, or the ``start_at`` unit's input (the split dual
        forward, train/steps.py). ``tap_at``: return the named unit's input
        as ``tap``, with its autograd history, so a loss on the branch that
        starts there differentiates the prefix through it. ``remat``: each
        unit's activations are recomputed in the backward
        (layers.run_unit)."""
        if start_at is not None and start_at not in self.unit_names:
            raise ValueError(f"unknown start_at unit {start_at!r}")
        aux: Dict[str, Dict[str, Any]] = {}
        tap = None
        started = start_at is None
        for name in self.unit_names:
            started = started or name == start_at
            if not started:
                continue
            if tap_at == name:
                tap = x
            x, unit_aux = run_unit(getattr(self, name), x, ind,
                                   force_passport, remat)
            if name == "convbnrelu_1":
                if unit_aux is not None:
                    aux[name] = unit_aux
                if self.is_imagenet:
                    x = max_pool2d(x, 3, 2, padding=1)
            else:
                aux.update({f"{name}/{k}": v for k, v in unit_aux.items()})
        return ModelOutput(self.linear(global_avg_pool(x)), aux, tap)


def _factory(block_cls, num_blocks):
    def make(num_classes=10, norm_type="bn", passport_kwargs=None,
             private=False, imagenet=False, input_size=32, seed=0,
             dtype=None):
        return ResNet(block_cls, num_blocks, num_classes=num_classes,
                      norm_type=norm_type, passport_kwargs=passport_kwargs,
                      private=private, imagenet=imagenet,
                      input_size=input_size, seed=seed, dtype=dtype)

    return make


ResNet9 = _factory(BasicBlock, (1, 1, 1, 1))
ResNet18 = _factory(BasicBlock, (2, 2, 2, 2))
ResNet34 = _factory(BasicBlock, (3, 4, 6, 3))
ResNet50 = _factory(Bottleneck, (3, 4, 6, 3))
ResNet101 = _factory(Bottleneck, (3, 4, 23, 3))
ResNet152 = _factory(Bottleneck, (3, 8, 36, 3))


def ResNet18Private(num_classes=10, passport_kwargs=None, norm_type="bn",
                    imagenet=False, input_size=32, seed=0, dtype=None):
    return ResNet18(num_classes=num_classes, norm_type=norm_type,
                    passport_kwargs=passport_kwargs, private=True,
                    imagenet=imagenet, input_size=input_size, seed=seed,
                    dtype=dtype)


# Bottleneck passport models, the JAX package's extension beyond the
# reference (whose passport machinery stops at BasicBlock); same config
# format, sub-block names convbnrelu_1/convbnrelu_2/convbn_3/shortcut

def ResNet50Passport(num_classes=10, passport_kwargs=None, norm_type="bn",
                     imagenet=False, input_size=32, seed=0, dtype=None):
    return ResNet50(num_classes=num_classes, norm_type=norm_type,
                    passport_kwargs=passport_kwargs, imagenet=imagenet,
                    input_size=input_size, seed=seed, dtype=dtype)


def ResNet50Private(num_classes=10, passport_kwargs=None, norm_type="bn",
                    imagenet=False, input_size=32, seed=0, dtype=None):
    return ResNet50(num_classes=num_classes, norm_type=norm_type,
                    passport_kwargs=passport_kwargs, private=True,
                    imagenet=imagenet, input_size=input_size, seed=seed,
                    dtype=dtype)
