"""Import torchvision-format checkpoints (AlexNet, ResNet-18/34/50/101/152)
into the port.

Counterpart of ``deepipr_tpu/interop/torchvision_import.py``. The
reference's ``pretrained=True`` paths download torchvision weights and copy
them layer by layer (models/alexnet_normal.py:64-80,
models/resnet_normal.py:87-99); here a LOCAL torchvision state-dict file is
renamed into the reference layout and loaded through
``interop/torch_import.py``:

torchvision AlexNet:  features.{0,3,6,8,10}.{weight,bias} -> features_{0,2,4,5,6}.conv
                      classifier.{1,4,6}.{weight,bias}    -> classifier_{1,4,6}
torchvision ResNet18/34: conv1/bn1 -> convbnrelu_1.{conv,bn};
                      layerL.B.convN/bnN -> layerL_B.{convbnrelu_1,convbn_2};
                      layerL.B.downsample.{0,1} -> layerL_B.shortcut;
                      fc -> linear
torchvision ResNet50/101/152 (Bottleneck): layerL.B.conv{1,2,3}/bn{1,2,3}
                      -> layerL_B.{convbnrelu_1,convbnrelu_2,convbn_3};
                      the rest as ResNet18's

torchvision's AlexNet flattens its 256x6x6 map in (c, h, w) order, as the
port does, so ``classifier.1`` loads as it is. torchvision's Bottleneck
strides its 3x3 conv2, as the port's does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from deepipr_tpu_torch.interop.torch_import import (
    import_torch_state_dict,
    read_torch_file,
)

_ALEXNET_FEATURE_MAP = {"0": "0", "3": "2", "6": "4", "8": "5", "10": "6"}
_RESNET_SUB = {"conv1": "convbnrelu_1", "conv2": "convbn_2",
               "bn1": "convbnrelu_1", "bn2": "convbn_2"}
# Bottleneck (resnet50/101/152): three convs per block
_BOTTLENECK_SUB = {"conv1": "convbnrelu_1", "conv2": "convbnrelu_2",
                   "conv3": "convbn_3",
                   "bn1": "convbnrelu_1", "bn2": "convbnrelu_2",
                   "bn3": "convbn_3"}


def _rename_alexnet(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "features" and parts[1] in _ALEXNET_FEATURE_MAP:
            out[f"features.{_ALEXNET_FEATURE_MAP[parts[1]]}.conv.{parts[2]}"] = v
        elif parts[0] == "classifier":
            out[k] = v  # classifier.{1,4,6}.weight|bias map directly
        else:
            raise KeyError(f"unexpected torchvision alexnet key: {k}")
    return out


def _rename_resnet(sd: Mapping[str, torch.Tensor],
                   submap: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "conv1":
            out[f"convbnrelu_1.conv.{parts[1]}"] = v
        elif parts[0] == "bn1":
            out[f"convbnrelu_1.bn.{parts[1]}"] = v
        elif parts[0] == "fc":
            out[f"linear.{parts[1]}"] = v
        elif parts[0].startswith("layer"):
            layer, block, sub = parts[0], parts[1], parts[2]
            if sub == "downsample":
                which = "conv" if parts[3] == "0" else "bn"
                out[f"{layer}.{block}.shortcut.{which}.{parts[4]}"] = v
            elif sub in submap:
                kind = "conv" if sub.startswith("conv") else "bn"
                out[f"{layer}.{block}.{submap[sub]}.{kind}.{parts[3]}"] = v
            else:
                raise KeyError(f"unexpected torchvision resnet key: {k}")
        else:
            raise KeyError(f"unexpected torchvision resnet key: {k}")
    return out


def import_torchvision(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                       arch: str, source: str = "torchvision checkpoint"
                       ) -> None:
    """Load a torchvision state dict into ``model`` (in place), for arch
    'alexnet', 'resnet18'/'resnet', 'resnet34', 'resnet50', 'resnet101' or
    'resnet152'."""
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    if arch == "alexnet":
        renamed = _rename_alexnet(sd)
    elif arch in ("resnet18", "resnet", "resnet34"):
        renamed = _rename_resnet(sd, _RESNET_SUB)
    elif arch in ("resnet50", "resnet101", "resnet152"):
        renamed = _rename_resnet(sd, _BOTTLENECK_SUB)
    else:
        raise ValueError(f"unsupported torchvision arch: {arch}")
    import_torch_state_dict(model, renamed, source)


def is_reference_layout(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state dict has the reference's module names
    (``features.4.conv.weight``, ``layer4.0.convbnrelu_1.bn.weight``), not
    torchvision's (``features.0.weight``, ``conv1.weight``)."""
    return any(".conv." in k or ".bn." in k
               or k.startswith(("convbnrelu", "linear.")) for k in sd)


def load_torch_pretrained(path: str, model: torch.nn.Module,
                          arch: str) -> None:
    """Load a ``.pth``/``.pt`` file into ``model`` (in place), sniffing the
    layout: a reference-layout state dict (what the reference's Experiment
    saves, experiments/base.py:139-150) goes through
    ``torch_import.import_torch_state_dict``, a torchvision one through
    ``import_torchvision``. This is what ``--pretrained-path model.pth``
    dispatches to."""
    sd = read_torch_file(path)
    if is_reference_layout(sd):
        import_torch_state_dict(model, sd, path)
    else:
        import_torchvision(sd, model, arch, path)
