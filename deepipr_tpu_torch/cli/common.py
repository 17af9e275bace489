"""Shared plumbing of the deployment and dispute CLIs (``verify_ownership``,
``export_deployment``, ``serve_http``, ``export_torch_checkpoint``,
``train_ensemble``): a model rebuilt from its passport config and a
checkpoint read into it.

A checkpoint is the port's own (``utils/checkpoint.py``: a train state or a
``save_model`` file) or a reference-layout ``.pth``/``.pt``
(``interop/torch_import.py``), read as the attack CLIs read it: with
``weights_only=True``, strict on passports and signatures (W8).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from deepipr_tpu_torch.interop.torchvision_import import load_torch_pretrained
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.utils.checkpoint import load_model
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    mark_separate_stats,
)
from deepipr_tpu_torch.utils.device import DeviceLike


def passport_kwargs(config_path: Optional[str], norm_type: str,
                    key_type: str, sign_loss: float,
                    separate_stats: bool = False
                    ) -> Optional[Dict[str, Any]]:
    """The per-layer passport kwargs of a config file (None without one),
    marked for per-branch BN statistics with ``separate_stats``."""
    if not config_path:
        return None
    with open(config_path) as f:
        kw, _ = construct_passport_kwargs(json.load(f), norm_type, key_type,
                                          sign_loss)
    if separate_stats:
        mark_separate_stats(kw)
    return kw


def load_checkpoint(path: str, model: torch.nn.Module, arch: str
                    ) -> torch.nn.Module:
    """Read ``path`` into ``model`` (in place, on its device): a port
    checkpoint, or a reference or torchvision ``.pth``/``.pt`` (layout
    sniffed, as ``--pretrained-path`` reads one)."""
    if path.endswith((".pth", ".pt")):
        load_torch_pretrained(path, model, arch)
    else:
        load_model(path, model)
    return model


def checkpoint_model(path: str, arch: str, num_classes: int, norm_type: str,
                     kwargs: Optional[Dict[str, Any]], private: bool,
                     imgcrop: int, device: DeviceLike,
                     imagenet: bool = False) -> torch.nn.Module:
    """``build_model`` of the arguments (the input side ``imgcrop``), with
    the checkpoint at ``path`` read into it, in eval mode on ``device``."""
    model = build_model(arch, num_classes, norm_type, passport_kwargs=kwargs,
                        private=private, imagenet=imagenet,
                        input_size=imgcrop, device=device)
    return load_checkpoint(path, model, arch)
