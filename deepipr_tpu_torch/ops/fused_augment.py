"""Fused training input stage (kernel K1): CUDA kernel and its wrapper.

Counterpart of ``deepipr_tpu/ops/pallas_augment.py``. One launch gathers a
batch of rows from the uint8 set resident on the card, zero-pads, crops at
the drawn offsets, flips, normalizes and writes the NCHW f32 batch the model
consumes (csrc/fused_augment.cu). For CPU tensors the call takes the plain
version, ``data/device_augment.py::augment_reference`` on the gathered rows.
There is no switch: on the GPU the kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from deepipr_tpu_torch.data.device_augment import augment_reference
from deepipr_tpu_torch.ops import cuda_build

# 8 pointers; n_set, b, h, w, c, pad, device; the stream
_C_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check(images_u8, idx, oy, ox, flip, mean255, std255, pad) -> None:
    tensors = (images_u8, idx, oy, ox, flip, mean255, std255)
    if any(t.device != images_u8.device for t in tensors):
        raise ValueError("fused_augment: all tensors must be on one device")
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4:
        raise TypeError("fused_augment: the set must be (N, H, W, C) uint8, "
                        f"got {images_u8.dtype} {tuple(images_u8.shape)}")
    b = idx.shape[0] if idx.ndim == 1 else -1
    for name, t in (("idx", idx), ("oy", oy), ("ox", ox), ("flip", flip)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,) or b < 1:
            raise ValueError(f"fused_augment: {name} must be (B,) int32 with "
                             f"B >= 1, got {t.dtype} {tuple(t.shape)}")
    c = images_u8.shape[3]
    for name, t in (("mean255", mean255), ("std255", std255)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"fused_augment: {name} must be ({c},) float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_augment takes contiguous tensors only")
    if pad < 0:
        raise ValueError(f"fused_augment: pad must be >= 0, got {pad}")


def _kernel():
    # CDLL caches the function object, so its signature is declared once
    fn = cuda_build.load("fused_augment").fused_augment_f32
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_augment(images_u8: torch.Tensor, idx: torch.Tensor,
                  oy: torch.Tensor, ox: torch.Tensor, flip: torch.Tensor,
                  mean255: torch.Tensor, std255: torch.Tensor,
                  pad: int) -> torch.Tensor:
    """Rows ``idx`` of the (N, H, W, C) uint8 set, padded by ``pad``, cropped
    at (oy, ox), flipped where ``flip``, normalized -> (B, C, H, W) f32.

    idx/oy/ox/flip: (B,) int32; mean255/std255: (C,) f32 (255 * ImageNet
    mean/std). Contiguous, all on one device. CPU tensors take the plain
    version; CUDA tensors launch the kernel and count the launch in
    ``fused_augment.launches``.
    """
    _check(images_u8, idx, oy, ox, flip, mean255, std255, pad)
    if images_u8.device.type == "cpu":
        return augment_reference(images_u8[idx.long()], oy, ox, flip, pad,
                                 mean255, std255)
    if images_u8.device.type != "cuda":
        raise ValueError(f"fused_augment: unsupported device {images_u8.device}")

    n_set, h, w, c = images_u8.shape
    b = idx.shape[0]
    out = torch.empty((b, c, h, w), dtype=torch.float32,
                      device=images_u8.device)
    index = images_u8.device.index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = _kernel()(
        images_u8.data_ptr(), idx.data_ptr(), oy.data_ptr(), ox.data_ptr(),
        flip.data_ptr(), mean255.data_ptr(), std255.data_ptr(),
        out.data_ptr(), n_set, b, h, w, c, int(pad), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_augment kernel launch failed: CUDA error {err}")
    fused_augment.launches += 1
    return out


fused_augment.launches = 0
