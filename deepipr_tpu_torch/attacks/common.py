"""Shared attack machinery: derived affines, global sign flips, detection.

Counterpart of ``deepipr_tpu/attacks/common.py``. Two kinds of names meet
here: the port's dotted module names (``layer4_0.convbnrelu_1``, what
``plkey_to_module_path`` returns and what state-dict entries start with) and
the JAX module paths (``layer4_0/convbnrelu_1``) that key the derived
affines and name the attacks' CSV columns, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from deepipr_tpu_torch.passport.codec import bit_accuracy
from deepipr_tpu_torch.utils.device import model_device
from deepipr_tpu_torch.utils.mode import eval_mode


def plkey_to_module_path(plkey: str) -> str:
    """Translate a passport-config key into the port's module name.

    '4' (alexnet feature index)        -> 'features_4'
    'layer4.0.convbnrelu_1' (resnet)   -> 'layer4_0.convbnrelu_1'
    'convbnrelu_1' (resnet stem)       -> 'convbnrelu_1'
    """
    parts = plkey.split(".")
    if len(parts) == 1:
        return f"features_{plkey}" if plkey.isdigit() else plkey
    layer, idx, module = parts
    return f"{layer}_{idx}.{module}"


def jax_path(name: str) -> str:
    """The JAX module path of a dotted module name."""
    return name.replace(".", "/")


def tree_order(names) -> List[str]:
    """``names`` in the order ``jax.tree.leaves`` takes the same leaves of a
    nested dict: sorted key by key, which for names of [A-Za-z0-9_] joined
    by '.' is the sorted order of the dotted names."""
    return sorted(names)


def derive(model, x: torch.Tensor, private: bool,
           tensors: Optional[Mapping[str, torch.Tensor]] = None
           ) -> Dict[str, Dict]:
    """{JAX module path: {'scale','bias','b','alpha'}} of one forward of the
    NCHW batch ``x`` with the passport branch forced, in eval mode, with
    ``tensors`` (passports, signatures, parameters by state-dict name)
    standing in for the model's own for this call. Differentiable: the
    caller chooses the grad mode."""
    kwargs = {"ind": 1} if private else {"force_passport": True}
    with eval_mode(model):
        if tensors is None:
            out = model(x, **kwargs)
        else:
            out = functional_call(model, dict(tensors), (x,), kwargs)
    return dict(out.aux)


@torch.inference_mode()
def derived_affines(model, input_shape, private: bool,
                    passports: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, Dict]:
    """{module_path: {'scale','bias','b','alpha'}} derived from the passports.

    One forward of a zeros batch of the NHWC ``input_shape`` with the
    passport branch forced (the reference calls get_scale()/get_bias() per
    layer, experiments/utils.py:201-202). ``passports`` maps passport buffer
    names (``layer4_0.convbnrelu_1.key``) to tensors that stand in for the
    model's own for this call only; the model is not modified. Runs in
    eval mode (running-statistic BN) whatever the model's mode.
    """
    return derive(model, zeros_input(model, input_shape), private, passports)


def zeros_input(model, input_shape) -> torch.Tensor:
    """An f32 NCHW zeros batch of the NHWC ``input_shape`` on the model's
    device."""
    n, h, w, c = input_shape
    return torch.zeros((n, c, h, w), dtype=torch.float32,
                       device=model_device(model))


def global_sign_flip(
    vectors: List[np.ndarray], perc: float, seed: int, to_unit_signs: bool = False
) -> Tuple[List[np.ndarray], float]:
    """Flip the sign of perc fraction of entries, chosen globally across all
    vectors (reference flip_attack.py:137-161 / passport_attack_2.py:261-287),
    with the JAX package's NumPy draws.

    to_unit_signs=True reproduces attack 2's quirk of REPLACING values with
    +-1 signs before flipping (passport_attack_2.py:273-281); False keeps
    magnitudes and only flips signs (flip attack).
    """
    sizes = [int(v.size) for v in vectors]
    total = sum(sizes)
    rng = np.random.default_rng(seed)
    idxs = rng.permutation(total)[: int(total * perc)]

    out, sims = [], []
    for v, size in zip(vectors, sizes):
        w = np.sign(v.copy()) if to_unit_signs else v.copy()
        local = idxs[idxs < size]
        orig_sign = np.sign(w)
        w[local] *= -1
        sims.append(float(np.mean(np.sign(w) == orig_sign)))
        out.append(w)
        idxs = idxs[idxs >= size] - size
    similarity = float(np.mean(sims)) if sims else 1.0
    return out, similarity


def detect_signature_from_affines(affines: Dict[str, Dict]) -> Dict[str, float]:
    """{layer: detection rate} using derived scales (reference
    pruning_attack.py:20-31: sign(get_scale(True)) vs b)."""
    return {
        path: float(bit_accuracy(aux["scale"], aux["b"]))
        for path, aux in affines.items()
    }
