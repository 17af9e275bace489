"""f32 on the card is IEEE f32: the port's TF32 pin, on the CPU.

``deepipr_tpu_torch/utils/device.py::resolve_device`` turns TF32 off in
cuDNN and cuBLAS whenever it resolves a CUDA device, as the JAX
reference's tests compute full f32 (``tests/conftest.py`` pins the highest
matmul precision). These tests hold the pin with ``torch.cuda.is_available``
patched, and hold by a scan of the sources that ``utils/device.py`` is the
one file of the port, ``chip_smoke.py`` and the port's tests that writes a
TF32 flag, through the legacy ``allow_tf32`` setters only.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from deepipr_tpu_torch.utils.device import resolve_device, torch_default_tf32

ROOT = Path(__file__).resolve().parents[1]
DEVICE_PY = ROOT / "deepipr_tpu_torch" / "utils" / "device.py"
# a write of a TF32 setting: an assignment or keyword (``allow_tf32 =``,
# ``flags(allow_tf32=...)``), a setattr by name, torch's private setters
# (``torch._C._set_cudnn_allow_tf32``), the matmul precision setter
WRITES = re.compile(
    r"\b(?:allow_tf32|fp32_precision)\s*=(?!=)"
    r"|setattr\([^)]*[\"'](?:allow_tf32|fp32_precision)[\"']"
    r"|\b_set_\w*(?:allow_tf32|fp32_precision)\b"
    r"|\bset_float32_matmul_precision\b")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flags() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both flags True, restored after the test (monkeypatch)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert flags() == (True, True)


def test_resolving_cuda_pins_tf32_off(monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dev = resolve_device("cuda")
    assert dev.type == "cuda"
    assert flags() == (False, False)
    resolve_device(torch.device("cuda", 0))
    assert flags() == (False, False)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
@pytest.mark.parametrize("start", [(True, True), (True, False),
                                   (False, False)])
def test_resolving_the_cpu_leaves_the_flags(monkeypatch, device, start):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", start[0])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", start[1])
    assert resolve_device(device).type == "cpu"
    assert flags() == start


def test_cuda_without_a_gpu_raises_and_leaves_the_flags(monkeypatch,
                                                        tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert flags() == (True, True)


def test_torch_defaults_hold_inside_the_block_only(monkeypatch, tf32_on):
    """chip_smoke.py's precision phase: torch's defaults (cuDNN TF32 on,
    cuBLAS off) inside, the pin after, also when the block raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    resolve_device("cuda")
    with torch_default_tf32():
        assert flags() == (True, False)
    assert flags() == (False, False)
    with pytest.raises(KeyError):
        with torch_default_tf32():
            raise KeyError("inside")
    assert flags() == (False, False)


def scanned() -> list:
    """The port's sources, chip_smoke.py and the port's test-side files,
    this file aside: it sets the flags through monkeypatch to test the
    pin, and restores them."""
    files = [*sorted((ROOT / "deepipr_tpu_torch").rglob("*.py")),
             ROOT / "chip_smoke.py",
             *sorted((ROOT / "tests").glob("test_torch_port_*.py")),
             *sorted((ROOT / "tests").glob("torch_port_*.py"))]
    return [f for f in files if f.resolve() != Path(__file__).resolve()]


def test_only_device_py_writes_a_tf32_flag():
    files = scanned()
    assert DEVICE_PY in files and ROOT / "chip_smoke.py" in files
    writers = {str(f.relative_to(ROOT)): WRITES.findall(f.read_text())
               for f in files}
    writers = {f: w for f, w in writers.items() if w}
    assert list(writers) == ["deepipr_tpu_torch/utils/device.py"], writers
    # the legacy setters only: reading a legacy flag raises once the newer
    # fp32_precision API has been written
    assert all("allow_tf32" in w for w in writers[str(
        DEVICE_PY.relative_to(ROOT))])


def test_no_module_of_the_port_calls_torch_default_tf32():
    """``torch_default_tf32`` is for measuring the fault: chip_smoke.py's
    precision phase takes it, no module of the port does."""
    port = sorted((ROOT / "deepipr_tpu_torch").rglob("*.py"))
    callers = [str(f.relative_to(ROOT)) for f in port
               if "torch_default_tf32" in f.read_text() and f != DEVICE_PY]
    assert callers == []
    assert "torch_default_tf32" in (ROOT / "chip_smoke.py").read_text()
