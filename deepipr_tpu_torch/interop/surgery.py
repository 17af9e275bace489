"""Model surgery: move weights between normal and passport variants.

Counterpart of ``deepipr_tpu/interop/surgery.py`` (reference
experiments/utils.py:100-239), on flat state dicts: the port's state-dict
names play the part of the JAX variable paths (``utils/tree.py`` is not
ported). Normal and passport models share module names by construction
(conv weights at ``<block>.conv.weight``, norms at ``<block>.bn``); the JAX
package's norm affine ``bn/scale``, ``bn/bias`` is the port's
``bn.weight``, ``bn.bias`` (interop/jax_params.py), and a state dict holds
the parameters and the BN running statistics together.

- passport -> normal: copy weights; materialize each passport layer's DERIVED
  scale/bias into the normal model's affine norm (utils.py:191-239).
- normal -> passport(learnable affine): copy weights; copy the normal model's
  norm affine into the passport layer's learnable scale/bias (utils.py:100-162).
- normal -> normal: plain weight copy minus the final classifier when
  requested (utils.py:165-188).

``plpaths`` are the port's dotted module names; ``derived`` is keyed by JAX
module path, as ``attacks/common.py::derived_affines`` returns it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from deepipr_tpu_torch.attacks.common import jax_path

State = Dict[str, torch.Tensor]


def _last_classifier_module(names) -> Optional[str]:
    """The FINAL classifier module name ('classifier', 'classifier_6', 'linear'):
    the reference resets/skips only the last layer (classification.py:181-190)."""
    mods = sorted({n.split(".")[0] for n in names
                   if n.startswith(("classifier", "linear"))})
    return mods[-1] if mods else None


def copy_matching(src: Mapping[str, torch.Tensor], dst: Mapping[str, torch.Tensor],
                  skip_last_classifier: bool = False) -> State:
    """Copy entries whose name and shape exist in both; dst keeps the rest."""
    out = dict(dst)
    last_cls = _last_classifier_module(out) if skip_last_classifier else None
    for name, v in src.items():
        if last_cls is not None and name.split(".")[0] == last_cls:
            continue
        if name in out and out[name].shape == v.shape:
            out[name] = v
    return out


def passport_to_normal(passport_state: Mapping[str, torch.Tensor],
                       derived: Dict[str, Dict],
                       normal_state: Mapping[str, torch.Tensor],
                       plpaths: List[str]) -> State:
    """The normal model's state dict built from a passport model's."""
    out = copy_matching(passport_state, normal_state)
    for path in plpaths:
        aux = derived[jax_path(path)]
        out[f"{path}.bn.weight"] = aux["scale"].reshape(-1)
        out[f"{path}.bn.bias"] = aux["bias"].reshape(-1)
        # separate-stats checkpoints: the derived affines were trained against
        # bn_private's running stats — pair them (copy_matching only sees the
        # shared 'bn' name, which holds the PUBLIC branch's stats)
        for stat in ("running_mean", "running_var"):
            priv = f"{path}.bn_private.{stat}"
            if priv in passport_state and f"{path}.bn.{stat}" in out:
                out[f"{path}.bn.{stat}"] = passport_state[priv]
    return out


def normal_to_passport(normal_state: Mapping[str, torch.Tensor],
                       passport_state: Mapping[str, torch.Tensor],
                       plpaths: List[str]) -> State:
    """A passport model's (with learnable affine) state dict built from a
    normal model's: norm affine -> learnable scale/bias."""
    out = copy_matching(normal_state, passport_state)
    for path in plpaths:
        if f"{path}.scale" in out and f"{path}.bn.weight" in normal_state:
            out[f"{path}.scale"] = normal_state[f"{path}.bn.weight"]
            out[f"{path}.bias"] = normal_state[f"{path}.bn.bias"]
    return out


def normal_to_normal(src_state: Mapping[str, torch.Tensor],
                     dst_state: Mapping[str, torch.Tensor],
                     skip_last_classifier: bool = True) -> State:
    """Weight copy between normal models (optionally keep dst's classifier —
    used when the class count differs in transfer learning)."""
    return copy_matching(src_state, dst_state,
                         skip_last_classifier=skip_last_classifier)
