"""Passport config handling, mirroring the reference JSON format.

Counterpart of ``deepipr_tpu/utils/config.py`` (kept as a copy: the port
imports nothing of the JAX package). passport_configs/*.json map layer keys
to ``false | true | "ascii string"`` (nested dicts for resnet layers); a
string means flag=True plus an embedded ASCII signature. Expansion mirrors
the reference's construct_passport_kwargs (experiments/utils.py:6-97).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


def _expand_leaf(value, norm_type, key_type, sl_ratio):
    b = value if isinstance(value, str) else None
    flag = True if b is not None else bool(value)
    kw = {
        "flag": flag,
        "norm_type": norm_type,
        "key_type": key_type,
        "sign_loss": sl_ratio,
    }
    if b is not None:
        kw["b"] = b
    return kw, flag


def construct_passport_kwargs(
    passport_config: Dict[str, Any],
    norm_type: str,
    key_type: str,
    sl_ratio: float,
) -> Tuple[Dict[str, Any], List[str]]:
    """Expand a passport config JSON into per-layer kwargs + passport-layer keys."""
    kwargs: Dict[str, Any] = {}
    plkeys: List[str] = []

    for layer_key, setting in passport_config.items():
        if isinstance(setting, dict):
            kwargs[layer_key] = {}
            for i, modules in setting.items():
                kwargs[layer_key][i] = {}
                for module_key, value in modules.items():
                    kw, flag = _expand_leaf(value, norm_type, key_type, sl_ratio)
                    kwargs[layer_key][i][module_key] = kw
                    if flag:
                        plkeys.append(f"{layer_key}.{i}.{module_key}")
        else:
            kw, flag = _expand_leaf(setting, norm_type, key_type, sl_ratio)
            kwargs[layer_key] = kw
            if flag:
                plkeys.append(layer_key)

    return kwargs, plkeys


def load_passport_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
