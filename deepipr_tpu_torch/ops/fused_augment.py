"""Fused training input stage (kernel K1): CUDA kernel and its wrapper.

Counterpart of ``deepipr_tpu/ops/pallas_augment.py``. One launch gathers a
batch of rows from the uint8 set resident on the card, zero-pads, crops at
the drawn offsets, flips, normalizes and writes the NCHW batch the model
consumes, in f32 or bf16 (the Pallas kernel's ``out_dtype``;
csrc/fused_augment.cu, one entry point per dtype). For CPU tensors the call
takes the plain version, ``data/device_augment.py::augment_reference`` on the
gathered rows. CUDA tensors launch the kernel with the geometry
``augment_geometry`` chooses. There is no switch: on the GPU the kernel runs
or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from deepipr_tpu_torch.data.device_augment import augment_reference
from deepipr_tpu_torch.ops import cuda_build

# 8 pointers; n_set, b, h, w, c, pad; tile_rows, threads, smem_bytes,
# vector_load, vector_store; device; the stream
_C_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

MAX_THREADS = 256  # kMaxThreads of csrc/fused_augment.cu
MAX_SMEM = 48 * 1024  # static shared-memory limit of a block, no opt-in


class AugmentGeometry(NamedTuple):
    """One launch of csrc/fused_augment.cu: block (b, t) writes output rows
    [t * tile_rows, (t + 1) * tile_rows) of image b."""
    grid: Tuple[int, int]  # (B, row tiles)
    threads: int
    tile_rows: int
    smem_bytes: int  # the (C,) statistics, then tile_rows source rows
    vector_load: bool  # 16-byte copies of the source rows
    vector_store: bool  # one store of 4 consecutive x (16 or 8 bytes)


_ENTRY = {torch.float32: "fused_augment_f32",
          torch.bfloat16: "fused_augment_bf16"}


def augment_geometry(b: int, h: int, w: int, c: int, set_ptr: int,
                     out_ptr: int, itemsize: int = 4) -> AugmentGeometry:
    """The launch geometry of kernel K1 for a (B, C, H, W) output of
    ``itemsize``-byte elements (4 f32, 2 bf16) gathered from an (N, H, W, C)
    uint8 set at address ``set_ptr`` into ``out_ptr``.

    A tile is the whole image while its H*W*C bytes fit MAX_SMEM beside the
    statistics (32x32x3 is 3,072), else as many even tiles of rows as it
    takes. Source rows are
    copied 16 bytes at a time when a row (W*C bytes) is a multiple of 16 and
    the set is 16-byte aligned; the output is stored 4 elements at a time
    when W is a multiple of 4 and the output is aligned to 4 elements.
    """
    if itemsize not in (2, 4):
        raise ValueError(f"fused_augment: {itemsize}-byte elements")
    row_bytes = w * c
    stats = -(-8 * c // 16) * 16
    max_rows = (MAX_SMEM - stats) // row_bytes
    if max_rows < 1:
        raise ValueError(f"fused_augment: a source row of {row_bytes} bytes "
                         "and the statistics do not fit shared memory")
    tiles = -(-h // min(h, max_rows))
    tile_rows = -(-h // tiles)
    vector_store = w % 4 == 0 and out_ptr % (4 * itemsize) == 0
    pieces = tile_rows * (w // 4 if vector_store else w)
    threads = min(MAX_THREADS, -(-pieces // 32) * 32)
    return AugmentGeometry(
        grid=(b, -(-h // tile_rows)), threads=threads, tile_rows=tile_rows,
        smem_bytes=stats + tile_rows * row_bytes,
        vector_load=row_bytes % 16 == 0 and set_ptr % 16 == 0,
        vector_store=vector_store)


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


def _kernel(dtype: torch.dtype):
    # CDLL caches the function object, so its signature is declared once
    fn = getattr(cuda_build.load("fused_augment"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_augment(images_u8: torch.Tensor, idx: torch.Tensor,
                  oy: torch.Tensor, ox: torch.Tensor, flip: torch.Tensor,
                  mean255: torch.Tensor, std255: torch.Tensor,
                  pad: int, out_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """Rows ``idx`` of the (N, H, W, C) uint8 set, padded by ``pad``, cropped
    at (oy, ox), flipped where ``flip``, normalized -> (B, C, H, W)
    ``out_dtype`` (f32 or bf16, the f32 value rounded to nearest even).

    idx/oy/ox/flip: (B,) int32; mean255/std255: (C,) f32 (255 * ImageNet
    mean/std). Contiguous, all on one device. CPU tensors take the plain
    version; CUDA tensors launch the kernel of ``out_dtype`` and count the
    launch in ``fused_augment.launches``.
    """
    _check(images_u8, idx, oy, ox, flip, mean255, std255, pad)
    if out_dtype not in _ENTRY:
        raise TypeError(f"fused_augment: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    if images_u8.device.type == "cpu":
        return augment_reference(images_u8[idx.long()], oy, ox, flip, pad,
                                 mean255, std255, out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"fused_augment: unsupported device {images_u8.device}")

    n_set, h, w, c = images_u8.shape
    b = idx.shape[0]
    out = torch.empty((b, c, h, w), dtype=out_dtype, device=images_u8.device)
    index = images_u8.device.index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    geo = augment_geometry(b, h, w, c, images_u8.data_ptr(), out.data_ptr(),
                           out.element_size())
    err = _kernel(out_dtype)(
        images_u8.data_ptr(), idx.data_ptr(), oy.data_ptr(), ox.data_ptr(),
        flip.data_ptr(), mean255.data_ptr(), std255.data_ptr(),
        out.data_ptr(), n_set, b, h, w, c, int(pad), geo.tile_rows,
        geo.threads, geo.smem_bytes, int(geo.vector_load),
        int(geo.vector_store), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_augment kernel launch failed: CUDA error {err}")
    fused_augment.launches += 1
    fused_augment.form_launches[out_dtype] += 1
    return out


# launches of either form, and of each form (by the output dtype)
fused_augment.launches = 0
fused_augment.form_launches = dict.fromkeys(_ENTRY, 0)
