"""The two models of a configuration, each with the benchmark's values in
every leaf: the port's (the system under test) and the plain reference."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.resnet import RefResNet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaf_shapes(config: Dict) -> Dict[str, tuple]:
    """Every leaf the reference holds, by the state-dict name the program
    shares, with its shape (the reference built without storage)."""
    with torch.device("meta"):
        ref = RefResNet(config)
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def build_port_model(config: Dict, dtype: str, values: Dict[str, torch.Tensor],
                     device: torch.device):
    """The port's V2 model of ``config`` in compute dtype ``dtype`` on
    ``device``, every leaf set to ``values`` (the names must be the
    program's, all of them)."""
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import construct_passport_kwargs

    if config["scheme"] != 2:
        raise ValueError("the benchmark's models are V2 (scheme 2)")
    kwargs, _ = construct_passport_kwargs(
        config["passport_config"], config["norm_type"], config["key_type"],
        config["sign_loss"])
    compute = DTYPES[dtype]
    model = build_model(config["arch"], config["num_classes"],
                        norm_type=config["norm_type"],
                        passport_kwargs=kwargs, private=True,
                        input_size=config["input_size"],
                        dtype=None if compute == torch.float32 else compute,
                        device=device)
    model.load_state_dict(values, strict=True)
    return model


def reference_model(config: Dict, dtype: str,
                    values: Dict[str, torch.Tensor],
                    device: torch.device) -> RefResNet:
    with torch.device(device):
        ref = RefResNet(config, DTYPES[dtype])
    ref.load_state_dict(values, strict=True)
    return ref
