"""Export a port model to the reference's PyTorch state-dict layout.

Counterpart of ``deepipr_tpu/interop/torch_export.py``: a model trained
here becomes a state dict that the reference code (kamwoh/DeepIPR) loads
with strict=True, so a reference user can verify ownership in their own
stack. The layout (models/layers/passportconv2d_private.py, passportconv2d.py):

  <mod>.conv.weight|bias            -> the same, with the module path in the
                                       reference's form (layer4_0 ->
                                       layer4.0, features_4 -> features.4,
                                       classifier_1 -> classifier.1)
                                       [+ <mod>.weight on passport blocks: the
                                       reference registers
                                       self.weight = self.conv.weight]
  <mod>.bn.weight|bias|running_*    -> the same (+ num_batches_tracked, int64 0)
  <mod>.scale|bias (learned affine) -> the same
  <mod>.key|skey                    -> <mod>.key[_private]|skey[_private];
                                       _private iff the model is V2/V3
  <mod>.b                           -> <mod>.b and <mod>.sign_loss[_private].b
  linear|classifier*.weight|bias    -> the same

Unlike the JAX package, the port flattens AlexNet's map in (c, h, w) order,
as the reference does, so no classifier column is reordered. The ImageNet
ResNet stem lives inside an nn.Sequential with the max pool in the
reference, so ``convbnrelu_1.*`` exports as ``convbnrelu_1.0.*``
(resnet_passport_private.py:96-99). Separate-stats models cannot be
exported: the reference has no per-branch BN statistics.
"""

from __future__ import annotations

from typing import Dict

import torch

from deepipr_tpu_torch.models.resnet import ResNet


def reference_module(name: str) -> str:
    """A port module name in the reference's form: 'layer4_0.convbn_2' ->
    'layer4.0.convbn_2', 'features_4' -> 'features.4', 'classifier_1' ->
    'classifier.1'."""
    parts = []
    for seg in name.split("."):
        head, _, idx = seg.rpartition("_")
        if idx.isdigit() and (head in ("features", "classifier") or (
                head.startswith("layer") and head[5:].isdigit())):
            parts.append(f"{head}.{idx}")
        else:
            parts.append(seg)
    return ".".join(parts)


@torch.no_grad()
def export_torch_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's weights, statistics, passports and signatures as a
    reference-layout state dict of CPU tensors."""
    own = model.state_dict()
    if any(".bn_private." in k for k in own):
        raise ValueError(
            "separate_stats models cannot be exported: the reference has no "
            "per-branch BN buffers (one shared affine-free norm, "
            "passportconv2d_private.py:56-64)")
    private = bool(getattr(model, "private", False))
    key_suffix = "_private" if private else ""
    sign_loss = "sign_loss_private" if private else "sign_loss"
    passport_blocks = {k.rsplit(".", 1)[0] for k in own
                       if k.rsplit(".", 1)[-1] == "key"}
    imagenet_stem = isinstance(model, ResNet) and model.is_imagenet

    def tmod(mod: str) -> str:
        t = reference_module(mod)
        if imagenet_stem and mod.split(".")[0] == "convbnrelu_1":
            t = "convbnrelu_1.0" + t[len("convbnrelu_1"):]
        return t

    out: Dict[str, torch.Tensor] = {}
    for name, v in own.items():
        mod, leaf = name.rsplit(".", 1)
        v = v.detach().to("cpu", torch.float32, copy=True)
        if leaf in ("key", "skey"):
            out[f"{tmod(mod)}.{leaf}{key_suffix}"] = v
        elif leaf == "b":
            out[f"{tmod(mod)}.b"] = v
            out[f"{tmod(mod)}.{sign_loss}.b"] = v.clone()
        elif leaf in ("running_mean", "running_var"):
            out[f"{tmod(mod)}.{leaf}"] = v
            out[f"{tmod(mod)}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
        else:
            out[f"{tmod(mod)}.{leaf}"] = v
            block = mod.removesuffix(".conv")
            if leaf == "weight" and mod.endswith(".conv") and \
                    block in passport_blocks:
                out[f"{tmod(block)}.weight"] = v.clone()
    return out


def save_torch_checkpoint(path: str, model) -> None:
    """``torch.save`` of ``export_torch_state_dict(model)``: a
    reference-loadable .pth."""
    torch.save(export_torch_state_dict(model), path)
