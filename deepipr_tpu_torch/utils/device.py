"""Device selection for the port's entry points.

Entry points default to the GPU and never drop to the CPU on their own: a
caller without a GPU gets an error unless it asks for ``device="cpu"``.

f32 on the card is IEEE f32, as in the JAX reference's tests (they pin
``jax_default_matmul_precision = "highest"``, so its convolutions
accumulate in full f32). Every entry point resolves its device here, and
``resolve_device`` pins TF32 off in cuDNN and cuBLAS whenever it resolves
a CUDA device: torch's default runs f32 convolutions in TF32 (a 10-bit
mantissa), which no card-vs-CPU bound holds. There is no switch, no
environment variable and no TF32 mode. This module is the one place that
writes the flags, through the legacy ``allow_tf32`` setters: once torch's
newer ``fp32_precision`` settings have been written, reading the legacy
flags raises.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Iterator, Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a GPU. A
    CUDA device pins TF32 off (module docstring); the CPU touches nothing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        _set_tf32(cudnn=False, matmul=False)
    return dev


def _set_tf32(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def torch_default_tf32() -> Iterator[None]:
    """Torch's own defaults for the block (cuDNN's f32 convolutions in
    TF32, cuBLAS's f32 matmuls in IEEE f32), pinned off again after: what
    the port's entry points computed before the pin. No entry point calls
    it; chip_smoke.py's precision phase measures that fault with it."""
    _set_tf32(cudnn=True, matmul=False)
    try:
        yield
    finally:
        _set_tf32(cudnn=False, matmul=False)


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
