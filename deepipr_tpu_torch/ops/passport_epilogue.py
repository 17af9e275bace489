"""Fused eval-path passport epilogue: CUDA kernel and its plain version.

Counterpart of ``deepipr_tpu/ops/pallas_fused.py``. After the one
convolution over ``[x; key; skey]`` of a passport block (passport/derive.py)
the rest of a BN passport block's eval path is

    scale = GAP(skey_out)          bias = GAP(key_out)          # (C,)
    out   = [relu](scale * ((y - mean) * rsqrt(var + eps)) + bias)

``y`` and ``out`` are f32 or bf16; the passport outputs, the statistics and
the returned scale/bias are f32, as in the Pallas kernel, which computes in
f32 and writes ``y.dtype``. ``passport_epilogue`` runs it as one kernel
(csrc/passport_epilogue.cu, one entry point per dtype) for CUDA tensors,
launched with the geometry ``epilogue_geometry`` chooses, and as
``passport_epilogue_reference`` for CPU tensors. There is no switch: on the
GPU the kernel runs or the call raises.
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

SPAN_ELEMENTS = 512  # one row's span of a block: 2 KB of f32 y, 1 KB of bf16
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
    vector: bool  # 16-byte loads and stores of y and out
    itemsize: int = 4  # bytes of an element of y and out: 4 f32, 2 bf16


def epilogue_geometry(n: int, c: int, hw: int, y_ptr: int, out_ptr: int,
                      itemsize: int = 4) -> EpilogueGeometry:
    """The launch geometry of kernel K2 for an (N, C, H*W) ``y`` of
    ``itemsize``-byte elements at address ``y_ptr`` and ``out`` at
    ``out_ptr``.

    A channel tile spans SPAN_ELEMENTS of a row (32 channels at H*W = 16),
    one thread per 16 bytes of it (4 f32 or 8 bf16; one element when H*W is
    not a multiple of that or a pointer is not 16-byte aligned), and at
    least one thread per STAGE passport floats of the tile. Rows per block:
    enough that the grid has about TARGET_BLOCKS blocks (8 at the main
    shape, all in flight at once). The passport planes are staged whole,
    unless the tile is one channel of more than STAGE floats a thread; then
    STAGE * threads of it at a time.
    """
    if itemsize not in (2, 4):
        raise ValueError(f"passport_epilogue: {itemsize}-byte elements")
    width = 16 // itemsize
    vector = hw % width == 0 and y_ptr % 16 == 0 and out_ptr % 16 == 0
    tile_c = min(c, max(1, SPAN_ELEMENTS // hw))
    positions = tile_c * hw // (width if vector else 1)
    threads = min(MAX_THREADS,
                  -(-max(positions, -(-tile_c * hw // STAGE)) // 32) * 32)
    c_tiles = -(-c // tile_c)
    if c_tiles > 65535:
        raise ValueError(f"passport_epilogue: {c} channels of {hw} positions "
                         "need more than 65535 channel tiles")
    tile_rows = min(n, -(-n * c_tiles // TARGET_BLOCKS))
    gap_len = hw if tile_c * hw <= STAGE * threads else STAGE * threads
    return EpilogueGeometry(
        grid=(-(-n // tile_rows), c_tiles), threads=threads, tile_c=tile_c,
        tile_rows=tile_rows, gap_len=gap_len,
        smem_bytes=4 * (4 * tile_c + 2 * tile_c * gap_len), vector=vector,
        itemsize=itemsize)


def fixed_order_gap(t: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) f32 -> (C,): the mean over H*W summed in the kernel's
    order, so the plain version's scale and bias equal the kernel's bit for
    bit. Stages of min(H*W, STAGE * MAX_THREADS) positions; in each, lane g
    of a group of G (the least power of two with STAGE * G >= the stage's
    length, at most 32) adds positions g, g + G, ... in order, a halving
    tree adds the G lanes, and the stage's sum is added to the earlier
    stages'; the total is divided by H*W."""
    c = t.shape[1]
    hw = t.shape[2] * t.shape[3]
    flat = t.reshape(c, hw)
    gap_len = min(hw, STAGE * MAX_THREADS)
    group = 1
    while group < 32 and STAGE * group < gap_len:
        group *= 2
    total = None
    for off in range(0, hw, gap_len):
        piece = flat[:, off:off + gap_len]
        lanes = torch.zeros((c, group), dtype=t.dtype, device=t.device)
        for k in range(0, piece.shape[1], group):
            chunk = piece[:, k:k + group]
            lanes[:, :chunk.shape[1]] += chunk
        width = group
        while width > 1:
            width //= 2
            lanes = lanes[:, :width] + lanes[:, width:2 * width]
        total = lanes[:, 0] if total is None else lanes[:, 0] + total
    return total / hw


def passport_epilogue_reference(
    y: torch.Tensor, key_out: torch.Tensor, skey_out: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
    relu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in the same order of operations
    and, for bf16 ``y``, with the same rounding points: the normalize in f32
    rounded to bf16 (flax's ``BatchNorm(dtype=bf16)``), then scale and bias
    cast to bf16 and the affine and ReLU in bf16 (the JAX package's
    ``layers.py:177-186``). For f32 ``y`` every cast is the identity. The
    GAP sums in the kernel's order (``fixed_order_gap``) and the inverse
    deviation is the correctly rounded ``1 / sqrt(var + eps)``, as the
    kernel takes them: a bf16 scale one f32 ulp from a bf16 rounding
    midpoint, or a normalize one ulp off, would otherwise round the other
    way, and where scale * yn and bias cancel that moves the small result
    by many of its own units."""
    scale = fixed_order_gap(skey_out)
    bias = fixed_order_gap(key_out)
    inv = 1.0 / torch.sqrt(var + eps)
    dt = y.dtype
    normed = ((y.to(torch.float32) - mean.view(1, -1, 1, 1))
              * inv.view(1, -1, 1, 1)).to(dt)
    out = scale.to(dt).view(1, -1, 1, 1) * normed + bias.to(dt).view(1, -1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out, scale, bias


_ENTRY = {torch.float32: "passport_epilogue_f32",
          torch.bfloat16: "passport_epilogue_bf16"}


def _check(y, key_out, skey_out, mean, var) -> None:
    tensors = (y, key_out, skey_out, mean, var)
    if y.dtype not in _ENTRY:
        raise TypeError(f"passport_epilogue: y must be float32 or bfloat16, "
                        f"got {y.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("passport_epilogue: key_out, skey_out, mean and var "
                        "must be float32")
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


def _kernel(dtype: torch.dtype):
    # CDLL caches the function object, so its signature is declared once
    fn = getattr(cuda_build.load("passport_epilogue"), _ENTRY[dtype])
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
    conv outputs of the passports; mean/var: (C,) BN running stats. y is
    f32 or bf16 and ``out`` has its dtype; everything else is f32; all
    contiguous. CPU tensors take the plain version; CUDA tensors launch the
    kernel of y's dtype and count the launch in
    ``passport_epilogue.launches``.
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
    geo = epilogue_geometry(n, c, h * w, y.data_ptr(), out.data_ptr(),
                            y.element_size())
    err = _kernel(y.dtype)(
        y.data_ptr(), key_out.data_ptr(), skey_out.data_ptr(),
        mean.data_ptr(), var.data_ptr(), out.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), n, c, h * w, geo.tile_c, geo.tile_rows, geo.threads,
        geo.gap_len, geo.smem_bytes, int(geo.vector), float(eps),
        int(bool(relu)), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"passport_epilogue kernel launch failed: CUDA error {err}")
    passport_epilogue.launches += 1
    passport_epilogue.form_launches[y.dtype] += 1
    return out, scale, bias


# launches of either form, and of each form (by the dtype of y)
passport_epilogue.launches = 0
passport_epilogue.form_launches = dict.fromkeys(_ENTRY, 0)
