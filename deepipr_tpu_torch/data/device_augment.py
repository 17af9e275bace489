"""Train-time augmentation on the device: plain PyTorch version and draws.

Counterpart of ``deepipr_tpu/data/device_augment.py``. The transform is the
reference's RandomCrop(pad) + RandomHorizontalFlip + Normalize
(dataset.py:268): zero-pad by ``pad``, crop at ``(oy, ox)`` in
``[0, 2*pad]``, flip the crop horizontally, then ``(x - 255*mean) /
(255*std)`` in f32, rounded to ``out_dtype`` (f32 or bf16) as the JAX
package's ``astype(out_dtype)`` rounds. The port emits NCHW, the layout its
model consumes.

The draws are explicit tensors, made by ``draw_augment`` from a
``torch.Generator`` (the counterpart of the JAX package's
``kc, kf = split(key)``; the numbers differ, so tests hand both sides the
same draws). ``augment_reference`` is the plain version of kernel K1
(``ops/fused_augment.py``), which takes it for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepipr_tpu_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def scaled_stats(mean=IMAGENET_MEAN, std=IMAGENET_STD, device="cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(255*mean, 255*std) as f32 (C,) tensors, rounded as the JAX package
    rounds them (f32 array times 255.0 in f32)."""
    m = torch.as_tensor(np.asarray(mean, np.float32), device=device) * 255.0
    s = torch.as_tensor(np.asarray(std, np.float32), device=device) * 255.0
    return m, s


def draw_augment(generator: torch.Generator, n: int, pad: int) -> Draws:
    """(oy, ox, flip), each (n,) int32 on the generator's device: offsets
    uniform in [0, 2*pad], flips with probability 1/2."""
    kw = dict(generator=generator, device=generator.device, dtype=torch.int32)
    oy = torch.randint(0, 2 * pad + 1, (n,), **kw)
    ox = torch.randint(0, 2 * pad + 1, (n,), **kw)
    flip = torch.randint(0, 2, (n,), **kw)
    return oy, ox, flip


def augment_reference(images_u8: torch.Tensor, oy: torch.Tensor,
                      ox: torch.Tensor, flip: torch.Tensor, pad: int,
                      mean255: torch.Tensor, std255: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) ``out_dtype``: pad, crop, flip,
    normalize in f32, then round."""
    b, h, w, _ = images_u8.shape
    x = F.pad(images_u8.to(torch.float32), (0, 0, pad, pad, pad, pad))
    dev = x.device
    rows = oy.long()[:, None] + torch.arange(h, device=dev)[None, :]
    cols = ox.long()[:, None] + torch.arange(w, device=dev)[None, :]
    x = x[torch.arange(b, device=dev)[:, None, None], rows[:, :, None],
          cols[:, None, :]]
    x = torch.where(flip.bool()[:, None, None, None], x.flip(2), x)
    return ((x - mean255) / std255).to(out_dtype).permute(0, 3, 1, 2) \
        .contiguous()


def make_device_augment(pad: int, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                        out_dtype: torch.dtype = torch.float32):
    """augment(draws, images_u8) -> normalized NCHW ``out_dtype`` batch, the
    plain version (``images_u8`` is (B, H, W, C) uint8, ``draws`` from
    ``draw_augment``). pad=0 degrades to flip + normalize."""

    def augment(draws: Draws, images_u8: torch.Tensor) -> torch.Tensor:
        m, s = scaled_stats(mean, std, images_u8.device)
        return augment_reference(images_u8, *draws, pad, m, s, out_dtype)

    return augment


def normalize_device(images_u8: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H, W) ``out_dtype``, normalized in f32,
    no augmentation (the V3 trigger batch's transform)."""
    m, s = scaled_stats(device=images_u8.device)
    return ((images_u8.to(torch.float32) - m) / s).to(out_dtype) \
        .permute(0, 3, 1, 2).contiguous()
