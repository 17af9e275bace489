"""Import reference-layout (kamwoh/DeepIPR) PyTorch checkpoints into the port.

Counterpart of ``deepipr_tpu/interop/torch_import.py``. The reference's
state-dict names become the port's by module path; values keep their
layout, since the port is NCHW and OIHW like the reference:

  features.4.conv.weight              -> features_4.conv.weight
  layer4.0.convbnrelu_1.bn.*          -> layer4_0.convbnrelu_1.bn.*
  convbnrelu_1.0.* (ImageNet stem,    -> convbnrelu_1.*
    a Sequential with the max pool)
  classifier.1.weight                 -> classifier_1.weight
  <mod>.key_private|skey_private      -> <mod>.key|skey (V2/V3)
  <mod>.scale|bias (learned affine)   -> the same, flattened to (C,)
  <mod>.weight beside <mod>.conv.weight (the reference's alias),
  *.sign_loss.b, *.sign_loss_private.b, num_batches_tracked -> dropped

Unlike the JAX package (torch_import.py:32-44), no classifier column is
reordered: the port flattens its NCHW map in (c, h, w) order, as the
reference does. Files are read with ``torch.load(weights_only=True)`` (W8):
no pickled code runs. A load is as strict as a port checkpoint's
(``utils/checkpoint.py::load_model_entries``): an unmatched passport or
signature entry raises, and so do a missing entry and a shape mismatch;
entries the model lacks are dropped with a printed list. The JAX package's
non-strict fallback (attacks/cli_common.py:125-134) is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from deepipr_tpu_torch.utils.checkpoint import load_model_entries

_IGNORED = ("num_batches_tracked", "sign_loss.b", "sign_loss_private.b")


def port_module(parts: List[str]) -> str:
    """['features', '4'] -> 'features_4'; ['layer1', '0', 'convbn_2'] ->
    'layer1_0.convbn_2'; ['convbnrelu_1', '0'] -> 'convbnrelu_1' (the
    ImageNet stem's Sequential index)."""
    out: List[str] = []
    for p in parts:
        if p.isdigit():
            if out and out[-1].startswith(("features", "layer",
                                           "classifier")):
                out[-1] = f"{out[-1]}_{p}"
            # else: a Sequential wrapper's index, dropped
        else:
            out.append(p)
    return ".".join(out)


def port_state_dict(sd: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict under the port's names (f32 CPU
    tensors), the ignored entries and aliases dropped."""
    aliases = {k for k in sd
               if k.endswith(".weight") and f"{k[:-7]}.conv.weight" in sd}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key in aliases or key.endswith(_IGNORED):
            continue
        *mods, leaf = key.split(".")
        mod = port_module(mods)
        v = torch.as_tensor(value).detach().to("cpu", torch.float32)
        if leaf in ("key_private", "skey_private"):
            leaf = leaf.removesuffix("_private")
        elif leaf in ("scale", "bias") and not mod.endswith(
                (".bn", ".conv", ".bn_private")) and v.ndim != 1:
            v = v.reshape(-1)  # learned affine stored as (1, C, 1, 1)
        out[f"{mod}.{leaf}" if mod else leaf] = v
    return out


def import_torch_state_dict(model: torch.nn.Module,
                            sd: Mapping[str, torch.Tensor],
                            source: str = "torch checkpoint") -> None:
    """Load a reference-layout state dict into ``model``, in place
    (strict as ``utils/checkpoint.py::load_model_entries``)."""
    load_model_entries(model, port_state_dict(sd), source, "torch_import")


def read_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` state dict, read with weights_only=True and
    unwrapped from a ``state_dict`` or ``model`` entry."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
    return sd


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Load a reference ``.pth`` file into ``model``, in place."""
    import_torch_state_dict(model, read_torch_file(path), path)
