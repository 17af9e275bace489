"""Passport key setup: turn candidate images into per-layer passports.

Counterpart of ``deepipr_tpu/train/keys.py``. Reference flow
(passport_generator.py, classification.py:130-140, resnet_passport.py:32-65):
sample n images (20 for 'shuffle', 1 for 'image'), propagate them through a
PRETRAINED normal model, and for each passport layer snapshot the activation
map entering that layer; 'shuffle' then draws each passport channel from a
random (image, channel) pair (passport/selection.py).

The pretrained model runs once with a forward pre-hook on every block
(``ConvBlock``, ``PassportBlock``, ``PassportPrivateBlock``) recording its
input, keyed by the port's dotted module name; the normal and the passport
model share module names, so the taps line up with the passport buffers.
Each layer's selection seed is the JAX package's ``_layer_seed`` of the JAX
module path (``layer4_0/convbnrelu_1``), so the same taps give the same
passports as there.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from deepipr_tpu_torch.models.layers import ConvBlock, _PassportBase
from deepipr_tpu_torch.ops.norms import BatchNorm
from deepipr_tpu_torch.passport.selection import passport_selection
from deepipr_tpu_torch.utils.device import model_device, nhwc_to_nchw

_BLOCKS = (ConvBlock, _PassportBase)


def sample_candidates(images: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Sample n images without replacement (reference get_key,
    passport_generator.py:6-17)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(images.shape[0], size=n, replace=False)
    return np.asarray(images[idx])


@torch.no_grad()
def collect_taps(model: nn.Module, x) -> Dict[str, np.ndarray]:
    """Run the model once on the NHWC batch ``x``, returning {dotted block
    name: NCHW input activation}.

    Runs in train mode, as the reference does (it never puts the pretrained
    model in eval mode during set_intermediate_keys), so BN normalizes with
    the candidate batch's own statistics. The BN running statistics are
    saved before the pass and put back after it, and the model's mode is
    restored: the JAX package discards the statistic updates.
    """
    taps: Dict[str, np.ndarray] = {}
    hooks = []
    for name, module in model.named_modules():
        if isinstance(module, _BLOCKS):
            def record(_module, inputs, name=name):
                taps[name] = inputs[0].detach().float().cpu().numpy()
            hooks.append(module.register_forward_pre_hook(record))
    bufs = [buf for m in model.modules() if isinstance(m, BatchNorm)
            for buf in (m.running_mean, m.running_var)]
    saved = [b.clone() for b in bufs]
    modes = {m: m.training for m in model.modules()}
    try:
        model.train()
        model(nhwc_to_nchw(x, model_device(model)))
    finally:
        for h in hooks:
            h.remove()
        for b, s in zip(bufs, saved):
            b.copy_(s)
        for m, mode in modes.items():
            m.training = mode
    return taps


def get_intermediate_activation(model: nn.Module, x,
                                layer_path: str) -> np.ndarray:
    """NCHW input activation entering one named block (reference
    get_intermediate_key, passport_generator.py:20-27)."""
    taps = collect_taps(model, x)
    if layer_path not in taps:
        raise KeyError(f"no tap for layer {layer_path}; available: "
                       f"{sorted(taps)}")
    return taps[layer_path]


def _layer_seed(base_seed: int, path: str, which: str) -> int:
    """The JAX package's per-layer seed; ``path`` is the JAX module path
    (``layer4_0/convbnrelu_1``)."""
    h = hashlib.sha256(f"{base_seed}:{path}:{which}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def passport_layers(model: nn.Module) -> Iterable[str]:
    """Dotted names of the model's passport blocks."""
    return [name for name, m in model.named_modules()
            if isinstance(m, _PassportBase)]


def passports_from_taps(taps_x: Dict[str, np.ndarray],
                        taps_y: Dict[str, np.ndarray],
                        layers: Iterable[str],
                        seed: int = 0) -> Dict[str, torch.Tensor]:
    """{``<layer>.key``/``<layer>.skey``: (1, C, H, W) f32} for each passport
    layer: key from ``taps_x``, skey from ``taps_y`` (the reference's
    set_key(x, y), passportconv2d.py:125-137)."""
    out: Dict[str, torch.Tensor] = {}
    for name in layers:
        if name not in taps_x:
            raise KeyError(f"no tap for passport layer {name}; available: "
                           f"{sorted(taps_x)}")
        path = name.replace(".", "/")
        for which, cand in (("key", taps_x[name]), ("skey", taps_y[name])):
            if cand.shape[0] != 1:
                cand = passport_selection(cand, _layer_seed(seed, path, which))
            out[f"{name}.{which}"] = torch.from_numpy(
                np.ascontiguousarray(cand, np.float32))
    return out


def setup_passports(pretrained_model: nn.Module, target_model: nn.Module,
                    key_x: np.ndarray, key_y: Optional[np.ndarray],
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """Passports for every passport block of ``target_model`` from the
    pretrained model's activations of the NHWC candidates: ``key_x`` feeds
    the bias passports ('key'), ``key_y`` the scale passports ('skey'). The
    result is keyed as ``serve.passports(target_model)``; the caller copies
    it into the model."""
    taps_x = collect_taps(pretrained_model, key_x)
    taps_y = taps_x if key_y is None else collect_taps(pretrained_model,
                                                        key_y)
    return passports_from_taps(taps_x, taps_y, passport_layers(target_model),
                               seed=seed)
