"""Fused eval-path passport epilogue: CUDA kernel and its plain version.

Counterpart of ``deepipr_tpu/ops/pallas_fused.py``. After the one
convolution over ``[x; key; skey]`` of a passport block (passport/derive.py)
the rest of a BN passport block's eval path is

    scale = GAP(skey_out)          bias = GAP(key_out)          # (C,)
    out   = [relu](scale * ((y - mean) * rsqrt(var + eps)) + bias)

``passport_epilogue`` runs it as one kernel (csrc/passport_epilogue.cu) for
CUDA tensors, launched with the geometry ``epilogue_geometry`` chooses, and
as ``passport_epilogue_reference`` for CPU tensors. There is no switch: on
the GPU the kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from deepipr_tpu_torch.ops import cuda_build

# 8 pointers; n, c, hw; tile_c, tile_rows, threads, gap_len, smem_bytes,
# vector; eps; relu, device; the stream
_C_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]

SPAN_FLOATS = 512  # one row's span of a block: 2 KB of y
STAGE = 4  # kStage of csrc/passport_epilogue.cu: passport floats a thread
MAX_THREADS = 512  # kMaxThreads of csrc/passport_epilogue.cu
TARGET_BLOCKS = 512  # about four blocks per SM of an H100
MAX_SMEM = 48 * 1024  # static shared-memory limit of a block, no opt-in


class EpilogueGeometry(NamedTuple):
    """One launch of csrc/passport_epilogue.cu: block (r, t) covers batch
    rows [r * tile_rows, (r + 1) * tile_rows) of channels
    [t * tile_c, (t + 1) * tile_c)."""
    grid: Tuple[int, int]  # (row blocks, channel tiles)
    threads: int
    tile_c: int
    tile_rows: int
    gap_len: int  # positions of each channel's passport planes per stage
    smem_bytes: int
    vector: bool  # float4 loads and stores of y and out


def epilogue_geometry(n: int, c: int, hw: int, y_ptr: int,
                      out_ptr: int) -> EpilogueGeometry:
    """The launch geometry of kernel K2 for an (N, C, H*W) ``y`` at address
    ``y_ptr`` and ``out`` at ``out_ptr``.

    A channel tile spans SPAN_FLOATS of a row (32 channels at H*W = 16), one
    thread per float4 of it (per float when H*W % 4 != 0 or a pointer is not
    16-byte aligned). Rows per block: enough that the grid has about
    TARGET_BLOCKS blocks (8 at the main shape, all in flight at once). The
    passport planes are staged whole, unless the tile is one channel of
    more than STAGE floats a thread; then STAGE * threads of it at a time.
    """
    vector = hw % 4 == 0 and y_ptr % 16 == 0 and out_ptr % 16 == 0
    tile_c = min(c, max(1, SPAN_FLOATS // hw))
    positions = tile_c * hw // (4 if vector else 1)
    threads = min(MAX_THREADS, -(-positions // 32) * 32)
    c_tiles = -(-c // tile_c)
    if c_tiles > 65535:
        raise ValueError(f"passport_epilogue: {c} channels of {hw} positions "
                         "need more than 65535 channel tiles")
    tile_rows = min(n, -(-n * c_tiles // TARGET_BLOCKS))
    gap_len = hw if tile_c * hw <= STAGE * threads else STAGE * threads
    return EpilogueGeometry(
        grid=(-(-n // tile_rows), c_tiles), threads=threads, tile_c=tile_c,
        tile_rows=tile_rows, gap_len=gap_len,
        smem_bytes=4 * (4 * tile_c + 2 * tile_c * gap_len), vector=vector)


def passport_epilogue_reference(
    y: torch.Tensor, key_out: torch.Tensor, skey_out: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
    relu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in the same order of operations."""
    scale = skey_out.mean(dim=(0, 2, 3))
    bias = key_out.mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + eps)
    out = (scale.view(1, -1, 1, 1)
           * ((y - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1))
           + bias.view(1, -1, 1, 1))
    if relu:
        out = torch.relu(out)
    return out, scale, bias


def _check(y, key_out, skey_out, mean, var) -> None:
    tensors = (y, key_out, skey_out, mean, var)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("passport_epilogue takes float32 tensors only")
    if any(t.device != y.device for t in tensors):
        raise ValueError("passport_epilogue: all tensors must be on one device")
    if y.ndim != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    _, c, h, w = y.shape
    for name, t in (("key_out", key_out), ("skey_out", skey_out)):
        if tuple(t.shape) != (1, c, h, w):
            raise ValueError(
                f"{name} must be (1, {c}, {h}, {w}), got {tuple(t.shape)}")
    for name, t in (("mean", mean), ("var", var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("passport_epilogue takes contiguous tensors only")


def _kernel():
    # CDLL caches the function object, so its signature is declared once
    fn = cuda_build.load("passport_epilogue").passport_epilogue_f32
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def passport_epilogue(
    y: torch.Tensor, key_out: torch.Tensor, skey_out: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
    relu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eval-mode passport epilogue -> (out, scale, bias).

    y: (N, C, H, W) conv output of the inputs; key_out/skey_out: (1, C, H, W)
    conv outputs of the passports; mean/var: (C,) BN running stats. All f32
    and contiguous. CPU tensors take the plain version; CUDA tensors launch
    the kernel and count the launch in ``passport_epilogue.launches``.
    """
    _check(y, key_out, skey_out, mean, var)
    if y.device.type == "cpu":
        return passport_epilogue_reference(y, key_out, skey_out, mean, var,
                                           eps=eps, relu=relu)
    if y.device.type != "cuda":
        raise ValueError(f"passport_epilogue: unsupported device {y.device}")

    n, c, h, w = y.shape
    out = torch.empty_like(y)
    scale = torch.empty(c, dtype=torch.float32, device=y.device)
    bias = torch.empty(c, dtype=torch.float32, device=y.device)
    index = y.device.index
    if index is None:
        index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    geo = epilogue_geometry(n, c, h * w, y.data_ptr(), out.data_ptr())
    err = _kernel()(
        y.data_ptr(), key_out.data_ptr(), skey_out.data_ptr(),
        mean.data_ptr(), var.data_ptr(), out.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), n, c, h * w, geo.tile_c, geo.tile_rows, geo.threads,
        geo.gap_len, geo.smem_bytes, int(geo.vector), float(eps),
        int(bool(relu)), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"passport_epilogue kernel launch failed: CUDA error {err}")
    passport_epilogue.launches += 1
    return out, scale, bias


passport_epilogue.launches = 0
