"""The host augment in C++ (csrc/augment.cpp), its build, and its plain
versions.

Counterpart of ``deepipr_tpu/data/native.py``. ``augment_normalize_native``
zero-pads, crops at the drawn offsets, flips and normalizes a uint8 NHWC
batch into float32 in one pass; ``normalize_native`` only normalizes. Both
compute ``v * (1 / (255 std)) + (-mean / std)`` as the JAX package's native
path does. Python owns the RNG: the caller draws the offsets and flips.
Each function counts its calls in ``<function>.calls``.

``get_lib`` compiles ``csrc/augment.cpp`` with ``g++`` and GXX_FLAGS, the
JAX package's flags, into ``augment-<hash>.so`` in ``cuda_build.BUILD_DIR``
(beside the CUDA kernels) at the first call, never at import, and loads it
with ``ctypes``. ``-march=native`` lets the compiler contract
``v * scale + bias`` into one fused multiply-add, which decides the
output's bytes, so the hash covers the source, the flags and the host (its
machine type, CPU model and CPU feature flags): on the same machine the
bytes are that package's. A compile goes to a name of its own and is
renamed into place, so processes that build at once leave one whole
library. There is no silent fallback: without ``g++``, or when the compile
fails, it raises.

``augment_normalize_plain`` and ``normalize_plain`` are the JAX package's
NumPy path (``(v / 255 - mean) / std``, its reference for the native
kernel), a float32 rounding apart from the native one; the tests and
``chip_smoke.py`` hold the native functions to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from deepipr_tpu_torch.ops import cuda_build

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
MAX_CHANNELS = 16  # the per-channel tables of csrc/augment.cpp

_lib = None
_lock = threading.Lock()


def _cpuinfo() -> Dict[str, str]:
    """The first processor's fields of /proc/cpuinfo ({} where there is
    none)."""
    fields: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return fields


def host_id() -> str:
    """The machine type and the CPU model (its vendor, family, model and
    stepping where the model name reads "unknown", as some virtual
    machines report it)."""
    info = _cpuinfo()
    model = info.get("model name", "unknown")
    if model == "unknown":
        model = " ".join(f"{k} {info[k]}" for k in (
            "vendor_id", "cpu family", "model", "stepping") if k in info)
    return f"{platform.machine()} {model or platform.processor()}"


def library_path() -> Path:
    """``-march=native`` compiles for this CPU: the name's hash covers the
    CPU's model and feature flags, so a library built on another host is
    not reused."""
    src = (cuda_build.CSRC / "augment.cpp").read_bytes()
    key = (src + " ".join(GXX_FLAGS).encode() + host_id().encode()
           + _cpuinfo().get("flags", "").encode())
    digest = hashlib.sha256(key).hexdigest()[:16]
    return cuda_build.BUILD_DIR / f"augment-{digest}.so"


def build() -> Path:
    """Compile ``csrc/augment.cpp`` unless it is built for this host; the
    library's path. Raises RuntimeError without ``g++`` or with the
    compiler's output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build augment.cpp "
                           "(the host data path has no other route)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, str(cuda_build.CSRC / "augment.cpp"), "-o",
         str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for augment.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The library, built first if needed, with its argument types set;
    built and loaded once per process. Raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.augment_u8_to_f32.argtypes = [
                u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, i32p, i32p, u8p, f32p, f32p,
            ]
            lib.normalize_u8_to_f32.argtypes = [
                u8p, f32p, ctypes.c_long, ctypes.c_int, f32p, f32p,
            ]
            _lib = lib
        return _lib


def _channels(batch_u8: np.ndarray, mean: np.ndarray, std: np.ndarray,
              fn: str) -> int:
    """The batch's channels C; raises ValueError for more than
    MAX_CHANNELS, or unless ``mean`` and ``std`` are both of shape (C,):
    the C++ reads C entries of each."""
    c = batch_u8.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"{fn}: {c} channels; the native kernel takes at "
                         f"most {MAX_CHANNELS}")
    if np.shape(mean) != (c,) or np.shape(std) != (c,):
        raise ValueError(f"{fn}: mean {np.shape(mean)} and std "
                         f"{np.shape(std)} for {c} channels; both must be "
                         f"({c},)")
    return c


def augment_normalize_native(batch_u8: np.ndarray, ys: np.ndarray,
                             xs: np.ndarray, flips: np.ndarray, pad: int,
                             mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Zero-pad by ``pad``, crop image i at rows ``ys[i]`` and columns
    ``xs[i]`` of the padded image (int32, in [0, 2 pad]), flip it where
    ``flips[i]`` (uint8) and normalize by the (C,) float32 ``mean`` and
    ``std``: (N, H, W, C) uint8 -> float32."""
    _channels(batch_u8, mean, std, "augment_normalize_native")
    lib = get_lib()
    b = np.ascontiguousarray(batch_u8)
    n, h, w, c = b.shape
    out = np.empty((n, h, w, c), np.float32)
    lib.augment_u8_to_f32(
        b, out, n, h, w, c, pad,
        np.ascontiguousarray(ys, np.int32),
        np.ascontiguousarray(xs, np.int32),
        np.ascontiguousarray(flips, np.uint8),
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
    )
    augment_normalize_native.calls += 1
    return out


def normalize_native(batch_u8: np.ndarray, mean: np.ndarray,
                     std: np.ndarray) -> np.ndarray:
    """(..., C) uint8 -> float32 normalized by the (C,) ``mean`` and
    ``std``."""
    c = _channels(batch_u8, mean, std, "normalize_native")
    lib = get_lib()
    b = np.ascontiguousarray(batch_u8)
    out = np.empty(b.shape, np.float32)
    lib.normalize_u8_to_f32(
        b, out, b.size // c, c,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
    )
    normalize_native.calls += 1
    return out


augment_normalize_native.calls = 0
normalize_native.calls = 0


def normalize_plain(batch_u8: np.ndarray, mean: np.ndarray,
                    std: np.ndarray) -> np.ndarray:
    """The plain version of ``normalize_native``: scaled to [0, 1], then
    the mean and std."""
    x = batch_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def _crop_flip(batch_u8: np.ndarray, ys: np.ndarray, xs: np.ndarray,
               flips: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad crop at (ys, xs) + horizontal flip where ``flips``, in
    uint8."""
    n, h, w, c = batch_u8.shape
    out = batch_u8
    if pad > 0:
        padded = np.pad(out, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="constant")
        out = np.stack([padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
                        for i in range(n)])
    out = out.copy()
    flips = np.asarray(flips).astype(bool)
    out[flips] = out[flips, :, ::-1]
    return out


def augment_normalize_plain(batch_u8: np.ndarray, ys: np.ndarray,
                            xs: np.ndarray, flips: np.ndarray, pad: int,
                            mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """The plain version of ``augment_normalize_native``."""
    return normalize_plain(_crop_flip(batch_u8, ys, xs, flips, pad), mean,
                           std)
