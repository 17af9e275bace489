"""Model zoo: AlexNet and ResNet families with passport variants.

Counterpart of ``deepipr_tpu/models/__init__.py``, with the names the port
builds (JAX's ResNet9Passport and ResNet18Passport are ``ResNet9`` and
``ResNet18`` without ``private``).
"""

from deepipr_tpu_torch.models.alexnet import (
    AlexNet,
    AlexNetNormal,
    AlexNetPassport,
    AlexNetPassportPrivate,
)
from deepipr_tpu_torch.models.layers import (
    ConvBlock,
    PassportBlock,
    PassportPrivateBlock,
)
from deepipr_tpu_torch.models.registry import ARCHS, NUM_CLASSES, build_model
from deepipr_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet9,
    ResNet18,
    ResNet18Private,
    ResNet34,
    ResNet50,
    ResNet50Passport,
    ResNet50Private,
    ResNet101,
    ResNet152,
)

__all__ = [
    "AlexNet",
    "AlexNetNormal",
    "AlexNetPassport",
    "AlexNetPassportPrivate",
    "ConvBlock",
    "PassportBlock",
    "PassportPrivateBlock",
    "ARCHS",
    "NUM_CLASSES",
    "build_model",
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet9",
    "ResNet18",
    "ResNet18Private",
    "ResNet34",
    "ResNet50",
    "ResNet50Passport",
    "ResNet50Private",
    "ResNet101",
    "ResNet152",
]
