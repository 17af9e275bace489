"""Build and load the hand-written CUDA kernels in ``deepipr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/deepipr_tpu_torch/<name>-<hash>.so``
beside the package, at first use, and loaded with ``ctypes``. The hash covers
the source and the flags, so an edited source is rebuilt. Nothing is
compiled at import: the CPU tests import every module without a toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

from deepipr_tpu_torch.utils.spans import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepipr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def toolkit_program(program: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH, or
    under CUDA_HOME (default /usr/local/cuda). Raises if neither has it."""
    found = shutil.which(program)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", program)
    if not os.path.exists(path):
        raise RuntimeError(f"{program} not found on PATH or under CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all at once.

    One ``nvcc`` per source, started together and then awaited. Returns
    {name: compiler output} for what was compiled (``-Xptxas -v`` reports
    registers, shared memory and spills). Raises if any compile fails.
    """
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = toolkit_program("nvcc")
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            reports[name] = log
        return reports
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def ptx(name: str) -> str:
    """The PTX that nvcc makes of ``csrc/<name>.cu`` for sm_90a at the
    build's optimisation level: what ptxas compiles into the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.ptx"
    subprocess.run([toolkit_program("nvcc"), "-arch=sm_90a", "-std=c++17",
                    "-O3", "-ptx", "-o", str(out), str(CSRC / f"{name}.cu")],
                   check=True, capture_output=True, text=True, timeout=600)
    return out.read_text()


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed. Its first load
    in a process is an ``ops.kernel_load`` span and counts in
    ``load.compiled`` (nvcc ran) or ``load.loaded`` (a library built before
    was reused), by kernel name."""
    lib = _LIBS.get(name)
    if lib is None:
        with span("ops.kernel_load"):
            compiled = build([name])
            lib = ctypes.CDLL(str(library_path(name)))
        counts = load.compiled if compiled else load.loaded
        counts[name] = counts.get(name, 0) + 1
        _LIBS[name] = lib
    return lib


load.compiled = {}
load.loaded = {}
