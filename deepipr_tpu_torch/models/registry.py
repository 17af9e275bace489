"""Model construction by architecture + scheme.

Counterpart of ``deepipr_tpu/models/registry.py`` (reference construct_model
dispatch, experiments/classification.py:66-126,
classification_private.py:66-106), for the archs ported so far: AlexNet,
ResNet9 and ResNet18.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deepipr_tpu_torch.models.alexnet import AlexNet
from deepipr_tpu_torch.models.resnet import ResNet9, ResNet18
from deepipr_tpu_torch.utils.device import DeviceLike, resolve_device

ARCHS = ("alexnet", "resnet", "resnet9", "resnet34", "resnet50")

NUM_CLASSES = {
    "cifar10": 10,
    "cifar100": 100,
    "caltech-101": 101,
    "caltech-256": 256,
    "imagenet1000": 1000,
    "synthetic": 10,
}

# archs of the JAX package that the port has not reached yet
_LATER = ("resnet34", "resnet50")


def build_model(
    arch: str,
    num_classes: int,
    norm_type: str = "bn",
    passport_kwargs: Optional[Dict[str, Any]] = None,
    private: bool = False,
    imagenet: bool = False,
    input_size: int = 32,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
):
    """Normal (passport_kwargs=None), V1 passport or V2/V3 private model,
    with random weights from ``seed``, in eval mode on ``device``.
    ``dtype`` (None or torch.bfloat16) is the compute dtype; the weights
    stay f32 (``registry.py:31`` of the JAX package)."""
    dev = resolve_device(device)
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"dtype must be None or torch.bfloat16, got {dtype}")
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue 1, item 4: "
            "Bottleneck, ResNet34/50)")
    if arch == "alexnet":
        make = AlexNet
    elif arch in ("resnet", "resnet18"):
        make = ResNet18
    elif arch == "resnet9":
        make = ResNet9
    else:
        raise ValueError(f"unknown arch: {arch} (choose from {ARCHS})")
    model = make(num_classes=num_classes, norm_type=norm_type,
                 passport_kwargs=passport_kwargs, private=private,
                 imagenet=imagenet, input_size=input_size, seed=seed,
                 dtype=dtype)
    return model.to(dev)
