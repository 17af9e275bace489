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

Under autograd (an f32 ``y``, ``key_out`` or ``skey_out`` that requires a
gradient, with grad mode on) a CUDA call goes through
``PassportEpilogueFunction``, whose backward is kernel K2-bwd
(``passport_epilogue_backward``, the same source: one launch, the ReLU mask
recomputed from y, scale and bias; its plain version is
``passport_epilogue_backward_reference``, which takes the mask from a given
``out``). The attacks differentiate the private forward with respect to the
passports through it, as the JAX package differentiates its XLA path. A CPU
call is differentiated by autograd through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deepipr_tpu_torch.ops import cuda_build

# 8 pointers; n, c, hw; tile_c, tile_rows, threads, gap_len, smem_bytes,
# vector, row_split; eps; relu, device; the stream
_C_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# K2-bwd: 14 pointers; n, c, hw; tile_c, tile_rows, threads, vector; eps;
# relu, device; the stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]

SPAN_ELEMENTS = 512  # one row's span of a block: 2 KB of f32 y, 1 KB of bf16
# kStage of csrc/passport_epilogue.cu: a GAP lane adds at most STAGE
# positions of a stage where the group's 32 lanes allow it, which fixes the
# GAP's summation order; also the positions a lane loads per round
STAGE = 4
MAX_THREADS = 512  # kMaxThreads of csrc/passport_epilogue.cu
MAX_GAP = STAGE * MAX_THREADS  # positions of a channel's planes a stage
TARGET_BLOCKS = 512  # about four blocks per SM of an H100
MAX_SMEM = 48 * 1024  # static shared-memory limit of a block, no opt-in
BWD_ROWS = 4  # kBwdUnroll of csrc/passport_epilogue.cu: K2-bwd's rows in flight
MAX_C_TILES = 65535  # CUDA's limit on gridDim.y: K2-bwd's arrival counters


class EpilogueGeometry(NamedTuple):
    """One launch of csrc/passport_epilogue.cu: block (r, t) covers batch
    rows [r * tile_rows, (r + 1) * tile_rows) of channels
    [t * tile_c, (t + 1) * tile_c)."""
    grid: Tuple[int, int]  # (row blocks, channel tiles)
    threads: int
    tile_c: int
    tile_rows: int
    gap_len: int  # positions of each channel's passport planes per GAP stage
    smem_bytes: int
    vector: bool  # 16-byte loads and stores of y and out
    itemsize: int = 4  # bytes of an element of y and out: 4 f32, 2 bf16
    # groups of threads // row_split threads, group g on rows g, g +
    # row_split, ... of the span
    row_split: int = 1


def epilogue_geometry(n: int, c: int, hw: int, y_ptr: int, out_ptr: int,
                      itemsize: int = 4) -> EpilogueGeometry:
    """The launch geometry of kernel K2 for an (N, C, H*W) ``y`` of
    ``itemsize``-byte elements at address ``y_ptr`` and ``out`` at
    ``out_ptr``.

    A channel tile spans SPAN_ELEMENTS of a row (32 channels at H*W = 16),
    a position of it for each 16 bytes (4 f32 or 8 bf16; one element when
    H*W is not a multiple of that or a pointer is not 16-byte aligned). The
    GAP wants a thread per STAGE passport floats of the tile, so that it
    sums every channel of the tile at once (exactly so where H*W / STAGE is
    a power of two, as at 4x4); where that is at least twice
    the positions (bf16's vectors: 128 threads for 64 positions at the main
    shape), the threads split the rows instead of idling: ``row_split``
    groups, each over the whole span. So every thread carries y, up to a
    warp's rounding and MAX_THREADS. Rows per block: enough that the grid
    has about TARGET_BLOCKS blocks (8 at the main shape, all in flight at
    once). The GAP sums MAX_GAP positions of a channel a stage at most
    (``gap_len``), which fixes its order (``fixed_order_gap``); shared
    memory holds the tile's four coefficient rows.
    """
    if itemsize not in (2, 4):
        raise ValueError(f"passport_epilogue: {itemsize}-byte elements")
    width = 16 // itemsize
    vector = hw % width == 0 and y_ptr % 16 == 0 and out_ptr % 16 == 0
    tile_c = min(c, max(1, SPAN_ELEMENTS // hw))
    positions = tile_c * hw // (width if vector else 1)
    lanes = min(MAX_THREADS,
                -(-max(positions, -(-tile_c * hw // STAGE)) // 32) * 32)
    row_split = max(1, lanes // positions)
    threads = min(MAX_THREADS, -(-positions * row_split // 32) * 32)
    c_tiles = -(-c // tile_c)
    if c_tiles > MAX_C_TILES:
        raise ValueError(f"passport_epilogue: {c} channels of {hw} positions "
                         "need more than 65535 channel tiles")
    tile_rows = min(n, -(-n * c_tiles // TARGET_BLOCKS))
    gap_len = min(hw, MAX_GAP)
    return EpilogueGeometry(
        grid=(-(-n // tile_rows), c_tiles), threads=threads, tile_c=tile_c,
        tile_rows=tile_rows, gap_len=gap_len,
        smem_bytes=4 * 4 * tile_c, vector=vector,
        itemsize=itemsize, row_split=row_split)


class BackwardGeometry(NamedTuple):
    """The one launch of K2-bwd: block (r, t) covers batch rows
    [r * tile_rows, (r + 1) * tile_rows) of channels [t * tile_c,
    (t + 1) * tile_c); a thread owns one 16-byte position of the span (or
    one element), or, when the tile is one channel, every ``threads``-th.
    The last of the grid[0] blocks of channel tile t to finish adds the
    tile's partials and writes its dkey_out and dskey_out planes."""
    grid: Tuple[int, int]  # (row blocks, channel tiles)
    threads: int
    tile_c: int
    tile_rows: int
    vector: bool  # float4 loads of g and y and stores of dy


def backward_geometry(n: int, c: int, hw: int, *ptrs: int
                      ) -> BackwardGeometry:
    """K2-bwd's geometry for an (N, C, H*W) f32 ``y``; ``ptrs``: the
    addresses of g, y and dy. The forward's tiles (SPAN_ELEMENTS of a
    row), with a thread for every position of a tile of several channels,
    and at least BWD_ROWS rows a block (so that every thread has that many
    rows of g and y in flight), more where the grid would otherwise exceed
    about TARGET_BLOCKS blocks."""
    vector = hw % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    tile_c = min(c, max(1, SPAN_ELEMENTS // hw))
    positions = tile_c * hw // (4 if vector else 1)
    threads = min(MAX_THREADS, -(-positions // 32) * 32)
    c_tiles = -(-c // tile_c)
    if c_tiles > MAX_C_TILES:
        raise ValueError(f"passport_epilogue_backward: {c} channels of {hw} "
                         "positions need more than 65535 channel tiles")
    tile_rows = min(n, max(BWD_ROWS, -(-n * c_tiles // TARGET_BLOCKS)))
    return BackwardGeometry(grid=(-(-n // tile_rows), c_tiles),
                            threads=threads, tile_c=tile_c,
                            tile_rows=tile_rows, vector=vector)


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
    gap_len = min(hw, MAX_GAP)
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
    # an IEEE division, as the kernel's: on CUDA, ATen multiplies by the
    # reciprocal of a Python-number divisor, which is not bit for bit
    return total / torch.full_like(total, hw)


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
    return _normalize_affine(y, scale, bias, mean, var, eps, relu), scale, bias


def _normalize_affine(y, scale, bias, mean, var, eps, relu):
    """The plain version's out from given scale and bias."""
    inv = 1.0 / torch.sqrt(var + eps)
    dt = y.dtype
    normed = ((y.to(torch.float32) - mean.view(1, -1, 1, 1))
              * inv.view(1, -1, 1, 1)).to(dt)
    out = scale.to(dt).view(1, -1, 1, 1) * normed + bias.to(dt).view(1, -1, 1, 1)
    return torch.relu(out) if relu else out


def passport_epilogue_backward_reference(
    g: torch.Tensor, y: torch.Tensor, out: torch.Tensor, scale: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor,
    g_scale: Optional[torch.Tensor] = None,
    g_bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
    relu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2-bwd -> (dy, dkey_out, dskey_out).

    The gradient of the f32 epilogue given g = dL/dout and the gradients of
    the returned scale and bias (None: zero). The ReLU mask is the forward
    output's ``out > 0``, so it is the forward's own mask (the derivative 0
    at 0, as ``jax.nn.relu``'s); mean and var take no gradient.
    """
    c = y.shape[1]
    hw = y.shape[2] * y.shape[3]
    inv = 1.0 / torch.sqrt(var + eps)
    gm = torch.where(out > 0, g, 0.0) if relu else g
    dy = gm * (scale * inv).view(1, -1, 1, 1)
    yn = (y - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    dscale = (gm * yn).sum(dim=(0, 2, 3))
    dbias = gm.sum(dim=(0, 2, 3))
    if g_scale is not None:
        dscale = dscale + g_scale
    if g_bias is not None:
        dbias = dbias + g_bias
    plane = (1, c, y.shape[2], y.shape[3])
    return (dy, (dbias / hw).view(1, -1, 1, 1).expand(plane).contiguous(),
            (dscale / hw).view(1, -1, 1, 1).expand(plane).contiguous())


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


def _kernel(entry: str, argtypes):
    # CDLL caches the function object, so its signature is declared once
    fn = getattr(cuda_build.load("passport_epilogue"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> Tuple[int, int]:
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


class PassportEpilogueFunction(torch.autograd.Function):
    """K2 with K2-bwd as its backward, for CUDA f32 tensors.

    Forward: the kernel, as ``passport_epilogue``. Backward: kernel K2-bwd
    (``passport_epilogue_backward``) on the saved y and the forward's scale
    and bias, from which it recomputes the ReLU mask. A gradient that
    autograd did not compute (an output no loss reaches) arrives as zeros.
    """

    @staticmethod
    def forward(ctx, y, key_out, skey_out, mean, var, eps, relu):
        out, scale, bias = _launch_forward(y, key_out, skey_out, mean, var,
                                           eps, relu)
        ctx.save_for_backward(y, bias, scale, mean, var)
        ctx.eps, ctx.relu = eps, relu
        return out, scale, bias

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_scale, g_bias):
        y, bias, scale, mean, var = ctx.saved_tensors
        dy, dkey_out, dskey_out = passport_epilogue_backward(
            g_out, y, bias, scale, mean, var, g_scale, g_bias, eps=ctx.eps,
            relu=ctx.relu)
        return dy, dkey_out, dskey_out, None, None, None, None


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
    ``passport_epilogue.launches``. With grad mode on and y, key_out or
    skey_out requiring a gradient, a CUDA call goes through
    ``PassportEpilogueFunction`` (f32 only: a bf16 y raises).
    """
    _check(y, key_out, skey_out, mean, var)
    if y.device.type == "cpu":
        return passport_epilogue_reference(y, key_out, skey_out, mean, var,
                                           eps=eps, relu=relu)
    if y.device.type != "cuda":
        raise ValueError(f"passport_epilogue: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, key_out, skey_out)):
        if y.dtype != torch.float32:
            raise NotImplementedError(
                "passport_epilogue: no backward kernel for bf16 y (ROADMAP "
                "queue 2, K2-bwd: f32 only; no entry point of the JAX "
                "package differentiates a bf16 eval forward)")
        return PassportEpilogueFunction.apply(y, key_out, skey_out, mean, var,
                                              eps, relu)
    return _launch_forward(y, key_out, skey_out, mean, var, eps, relu)


def _launch_forward(y, key_out, skey_out, mean, var, eps, relu):
    n, c, h, w = y.shape
    out = torch.empty_like(y)
    scale = torch.empty(c, dtype=torch.float32, device=y.device)
    bias = torch.empty(c, dtype=torch.float32, device=y.device)
    index, stream = _stream(y)
    geo = epilogue_geometry(n, c, h * w, y.data_ptr(), out.data_ptr(),
                            y.element_size())
    err = _kernel(_ENTRY[y.dtype], _C_ARGTYPES)(
        y.data_ptr(), key_out.data_ptr(), skey_out.data_ptr(),
        mean.data_ptr(), var.data_ptr(), out.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), n, c, h * w, geo.tile_c, geo.tile_rows, geo.threads,
        geo.gap_len, geo.smem_bytes, int(geo.vector), geo.row_split,
        float(eps), int(bool(relu)), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"passport_epilogue kernel launch failed: CUDA error {err}")
    passport_epilogue.launches += 1
    passport_epilogue.form_launches[y.dtype] += 1
    return out, scale, bias


# launches of either form, and of each form (by the dtype of y)
passport_epilogue.launches = 0
passport_epilogue.form_launches = dict.fromkeys(_ENTRY, 0)


_ARRIVALS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(index: int, stream: int) -> torch.Tensor:
    """K2-bwd's arrival counters for CUDA device ``index`` and ``stream``
    (a ``cuda_stream`` handle): MAX_C_TILES int32, zeroed once when first
    asked for. Each launch counts its blocks' arrivals there and its last
    blocks set them back to 0, so no call needs a fill kernel; launches on
    one stream run in order, so they share the buffer."""
    counters = _ARRIVALS.get((index, stream))
    if counters is None:
        counters = torch.zeros(MAX_C_TILES, dtype=torch.int32,
                               device=torch.device("cuda", index))
        _ARRIVALS[(index, stream)] = counters
    return counters


def passport_epilogue_backward(
    g: torch.Tensor, y: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor,
    g_scale: Optional[torch.Tensor] = None,
    g_bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
    relu: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2-bwd -> (dy, dkey_out, dskey_out), the gradient of the f32 epilogue
    (see ``passport_epilogue_backward_reference``), with the ReLU mask
    recomputed from y and the forward's scale and bias: the forward's own
    ``out > 0``, bit for bit, in either version.

    g and y: (N, C, H, W) f32; bias, scale, mean, var, g_scale, g_bias:
    (C,) f32 (gradients None: zero; the three gradients are made
    contiguous). CPU tensors take the plain version, with ``out`` from
    ``passport_epilogue_reference``'s arithmetic; CUDA tensors launch the
    kernel (one launch) and count it in
    ``passport_epilogue_backward.launches``.
    """
    if y.ndim != 4 or g.shape != y.shape:
        raise ValueError(f"passport_epilogue_backward: g {tuple(g.shape)} and "
                         f"y {tuple(y.shape)} must be one (N, C, H, W) shape")
    n, c, h, w = y.shape
    if g_scale is None:
        g_scale = torch.zeros(c, dtype=torch.float32, device=y.device)
    if g_bias is None:
        g_bias = torch.zeros(c, dtype=torch.float32, device=y.device)
    # autograd may hand over expanded or strided gradients
    g, g_scale, g_bias = (t.contiguous() for t in (g, g_scale, g_bias))
    tensors = (g, y, bias, scale, mean, var, g_scale, g_bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("passport_epilogue_backward takes float32 tensors "
                        "only (ROADMAP queue 2, K2-bwd: f32 only)")
    if any(t.device != y.device for t in tensors):
        raise ValueError("passport_epilogue_backward: all tensors must be on "
                         "one device")
    if any(tuple(t.shape) != (c,) for t in tensors[2:]):
        raise ValueError(f"passport_epilogue_backward: bias, scale, mean, var "
                         f"and the scale/bias gradients must be ({c},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("passport_epilogue_backward takes contiguous "
                         "tensors only")
    if y.device.type == "cpu":
        out = _normalize_affine(y, scale, bias, mean, var, eps, relu)
        return passport_epilogue_backward_reference(
            g, y, out, scale, mean, var, g_scale, g_bias, eps=eps, relu=relu)
    if y.device.type != "cuda":
        raise ValueError(f"passport_epilogue_backward: unsupported device "
                         f"{y.device}")

    dy = torch.empty_like(y)
    dkey_out = torch.empty((1, c, h, w), dtype=torch.float32, device=y.device)
    dskey_out = torch.empty_like(dkey_out)
    geo = backward_geometry(n, c, h * w, g.data_ptr(), y.data_ptr(),
                            dy.data_ptr())
    partials = torch.empty((2, c, geo.grid[0]), dtype=torch.float32,
                           device=y.device)
    index, stream = _stream(y)
    err = _kernel("passport_epilogue_backward_f32", _BWD_ARGTYPES)(
        g.data_ptr(), y.data_ptr(), bias.data_ptr(), scale.data_ptr(),
        mean.data_ptr(), var.data_ptr(), g_scale.data_ptr(),
        g_bias.data_ptr(), dy.data_ptr(), dkey_out.data_ptr(),
        dskey_out.data_ptr(), partials[0].data_ptr(), partials[1].data_ptr(),
        arrival_counters(index, stream).data_ptr(), n, c, h * w, geo.tile_c,
        geo.tile_rows, geo.threads, int(geo.vector), float(eps),
        int(bool(relu)), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"passport_epilogue_backward kernel launch failed: "
                           f"CUDA error {err}")
    passport_epilogue_backward.launches += 1
    return dy, dkey_out, dskey_out


passport_epilogue_backward.launches = 0
