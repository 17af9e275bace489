"""Device selection for the port's entry points.

Entry points default to the GPU and never drop to the CPU on their own: a
caller without a GPU gets an error unless it asks for ``device="cpu"``.
"""

from __future__ import annotations

import hashlib
from typing import Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def require_on_device(model: nn.Module, device: torch.device) -> None:
    """Raise unless the model's weights live on ``device``."""
    have = model_device(model)
    if have.type != device.type or (
        device.index is not None and have.index != device.index
    ):
        raise ValueError(
            f"model is on {have}, expected {device}: build it with "
            f"build_model(..., device={str(device)!r}) or move it with .to()"
        )


def nhwc_to_nchw(x, device: torch.device) -> torch.Tensor:
    """An NHWC batch (numpy or tensor) as a contiguous f32 NCHW tensor."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim != 4:
        raise ValueError(f"expected an NHWC batch, got shape {tuple(x.shape)}")
    return x.permute(0, 3, 1, 2).contiguous()


def seeded_generator(device: torch.device, seed: int, *fold: int
                     ) -> torch.Generator:
    """A generator on ``device`` whose stream depends on ``seed`` and the
    ``fold`` integers alone: the counterpart of ``jax.random.fold_in``
    (the streams differ from JAX's)."""
    digest = hashlib.blake2b(repr((seed, *fold)).encode(), digest_size=8)
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest.digest(), "little") >> 1)
    return gen
