"""AlexNet family: normal / V1 passport / V2-V3 private passport (NCHW).

Counterpart of ``deepipr_tpu/models/alexnet.py``; topology matches the
reference (models/alexnet_normal.py, alexnet_passport.py,
alexnet_passport_private.py):

- CIFAR variant: five conv blocks (64, 192, 384, 256, 256 channels; k 5, 5,
  3, 3, 3), max pooling (2, stride 2) after blocks 0, 2 and 6, and one
  Linear classifier on the flattened 256x4x4 map.
- ImageNet variant: block 0 is k 11, stride 4, padding 2, the pools are 3
  wide, and the head is AdaptiveAvgPool(6, 6) and a three-layer MLP with
  dropout 0.5 before each of its first two Linears.
- The conv and pool shapes key on ``num_classes == 1000`` alone, the head on
  ``imagenet or num_classes == 1000`` (the reference's quirk, kept by the
  JAX package at ``alexnet.py:129-130``): ``imagenet=True`` with 10 classes
  pools a 4x4 map up to 6x6.

Module names follow the JAX module paths (``features_4``, ``classifier``,
``classifier_1``), so a JAX variable tree maps onto the state dict by path
(interop/jax_params.py, which reorders the flattened classifier's input
rows: JAX flattens NHWC, this model NCHW, as the reference does). As in the
ResNet, ``dtype`` is the blocks' compute dtype and the head runs in f32.

Dropout is active in train mode only, and its masks are an argument of the
forward (``dropout_masks``), drawn by the caller: the train step draws them
from a generator that is a function of (seed, step) alone
(train/steps.py::seeded_dropout), as the JAX step folds the step into its
dropout key, and a test can hand over JAX's.
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
from deepipr_tpu_torch.ops.pooling import adaptive_avg_pool2d, max_pool2d

# (layer index, features, kernel, stride, padding): alexnet.py:26-40 of the
# JAX package
CIFAR_CONVS = [
    ("0", 64, 5, 1, 2),
    ("2", 192, 5, 1, 2),
    ("4", 384, 3, 1, 1),
    ("5", 256, 3, 1, 1),
    ("6", 256, 3, 1, 1),
]
IMAGENET_CONVS = [("0", 64, 11, 4, 2)] + CIFAR_CONVS[1:]
POOL_AFTER = ("0", "2", "6")  # max pooling, stride 2, after these blocks
HEAD_POOL = (6, 6)  # the ImageNet head's adaptive average pool
HIDDEN = 4096  # the ImageNet head's hidden width
DROPOUT_KEEP = 0.5  # flax nn.Dropout(0.5): keep each unit with p = 0.5


def _dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """flax's ``where(keep, x / keep_prob, 0)``; x / 0.5 is exact."""
    if keep.shape != x.shape or keep.dtype != torch.bool:
        raise ValueError(f"dropout mask {keep.dtype} {tuple(keep.shape)} for "
                         f"an input of shape {tuple(x.shape)}")
    return torch.where(keep, x / DROPOUT_KEEP, torch.zeros_like(x))


class AlexNet(nn.Module):
    """Unified AlexNet; passport_kwargs=None gives the normal model.

    ``private=True`` makes the flagged layers PassportPrivateBlocks (V2/V3).
    ``input_size`` is the image side (32 for CIFAR, 224 for ImageNet): it
    shapes the passports and the CIFAR classifier's input; ``seed`` seeds
    the random weights (layers.init_weights); ``dtype`` is the blocks'
    compute dtype (None: f32).
    """

    def __init__(self, num_classes: int = 10, in_channels: int = 3,
                 norm_type: str = "bn",
                 passport_kwargs: Optional[Dict[str, Any]] = None,
                 private: bool = False, imagenet: bool = False,
                 input_size: int = 32, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.norm_type = norm_type
        self.input_size = input_size
        self.passport_kwargs = passport_kwargs
        self.private = private
        self.dtype = dtype
        full_imagenet = num_classes == 1000
        self.head_imagenet = imagenet or full_imagenet
        self.pool_k = 3 if full_imagenet else 2
        self.unit_names: List[str] = []

        hw = (input_size, input_size)
        for idx, feats, k, s, p in (IMAGENET_CONVS if full_imagenet
                                    else CIFAR_CONVS):
            name = f"features_{idx}"
            layer_kwargs = None if passport_kwargs is None \
                else passport_kwargs[idx]
            self.add_module(name, make_block(
                layer_kwargs, norm_type, in_channels, feats, k, s, p,
                private, True, hw, dtype))
            self.unit_names.append(name)
            hw = conv_out_hw(hw, k, s, p)
            if idx in POOL_AFTER:
                hw = conv_out_hw(hw, self.pool_k, 2, 0)
            if min(hw) < 1:
                raise ValueError(f"AlexNet: a {input_size}x{input_size} "
                                 f"input leaves no map after {name}")
            in_channels = feats

        if self.head_imagenet:
            self.classifier_1 = nn.Linear(
                in_channels * HEAD_POOL[0] * HEAD_POOL[1], HIDDEN)
            self.classifier_4 = nn.Linear(HIDDEN, HIDDEN)
            self.classifier_6 = nn.Linear(HIDDEN, num_classes)
        else:
            self.classifier = nn.Linear(in_channels * hw[0] * hw[1],
                                        num_classes)
        init_weights(self, torch.Generator().manual_seed(seed))
        # built for inference; the train step switches to train mode, and
        # every eval entry point enters eval mode itself (utils/mode.py)
        self.eval()

    def dropout_shapes(self, n: int) -> List[Tuple[int, int]]:
        """The shapes of a batch of ``n``'s dropout masks: one per Dropout
        of the head, in order (none for the CIFAR head)."""
        if not self.head_imagenet:
            return []
        return [(n, self.classifier_1.in_features), (n, HIDDEN)]

    def forward(self, x, ind: int = 0, force_passport: bool = False,
                start_at: Optional[str] = None, tap_at: Optional[str] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                remat: bool = False) -> ModelOutput:
        """x: NCHW images, or the ``start_at`` block's input (the split dual
        forward, train/steps.py). ``tap_at``: return the named block's
        input, after the pool before it, as ``tap``, with its autograd
        history. ``dropout_masks``: boolean keep masks of
        ``dropout_shapes(N)``, required in train mode by the ImageNet head
        and ignored in eval mode. ``remat``: each block's activations are
        recomputed in the backward (layers.run_unit)."""
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
            if unit_aux is not None:
                aux[name] = unit_aux
            if name.removeprefix("features_") in POOL_AFTER:
                x = max_pool2d(x, self.pool_k, 2)

        if not self.head_imagenet:
            return ModelOutput(self.classifier(x.flatten(1).float()), aux,
                               tap)
        x = adaptive_avg_pool2d(x, HEAD_POOL).flatten(1)
        masks = None
        if self.training:
            if dropout_masks is None:
                raise ValueError("AlexNet's ImageNet head in train mode "
                                 "needs dropout_masks (train/steps.py draws "
                                 "them per step)")
            masks = list(dropout_masks)
            if len(masks) != 2:
                raise ValueError(f"{len(masks)} dropout masks, expected 2")
            x = _dropout(x, masks[0])
        x = F.relu(self.classifier_1(x.float()))
        if masks is not None:
            x = _dropout(x, masks[1])
        x = F.relu(self.classifier_4(x))
        return ModelOutput(self.classifier_6(x), aux, tap)


def AlexNetNormal(num_classes=10, in_channels=3, norm_type="bn",
                  imagenet=False, input_size=32, seed=0, dtype=None):
    return AlexNet(num_classes=num_classes, in_channels=in_channels,
                   norm_type=norm_type, imagenet=imagenet,
                   input_size=input_size, seed=seed, dtype=dtype)


def AlexNetPassport(num_classes, passport_kwargs, in_channels=3,
                    norm_type="bn", imagenet=False, input_size=32, seed=0,
                    dtype=None):
    return AlexNet(num_classes=num_classes, in_channels=in_channels,
                   norm_type=norm_type, passport_kwargs=passport_kwargs,
                   imagenet=imagenet, input_size=input_size, seed=seed,
                   dtype=dtype)


def AlexNetPassportPrivate(num_classes, passport_kwargs, in_channels=3,
                           norm_type="bn", imagenet=False, input_size=32,
                           seed=0, dtype=None):
    return AlexNet(num_classes=num_classes, in_channels=in_channels,
                   norm_type=norm_type, passport_kwargs=passport_kwargs,
                   private=True, imagenet=imagenet, input_size=input_size,
                   seed=seed, dtype=dtype)
