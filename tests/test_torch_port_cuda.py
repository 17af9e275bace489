"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA card each test skips: a CUDA kernel has no CPU mode, and the
CPU tests hold the plain versions to the JAX package instead
(tests/test_torch_port_kernels.py).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from deepipr_tpu_torch.data.device_augment import (
    augment_reference,
    draw_augment,
    scaled_stats,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.fused_augment import fused_augment
from deepipr_tpu_torch.ops.passport_epilogue import (
    passport_epilogue,
    passport_epilogue_reference,
)
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_train_step
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

CONFIGS = Path(__file__).resolve().parent.parent / "passport_configs"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# NCHW: the serving path's layer4 blocks at batch 256 and 1 (signature
# detection), and tests/test_pallas.py's shapes
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 4, 4), (1, 512, 4, 4),
                                   (4, 128, 8, 8), (2, 64, 56, 56)])
@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_kernel_matches_plain_version(cuda, shape, relu):
    n, c, h, w = shape
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(shape, generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn((1, c, h, w), generator=g),
            torch.randn(c, generator=g),
            0.5 + 1.5 * torch.rand(c, generator=g)]
    args = [a.to(cuda) for a in args]
    before = passport_epilogue.launches
    got = passport_epilogue(*args, relu=relu)
    torch.cuda.synchronize()
    assert passport_epilogue.launches == before + 1
    want = passport_epilogue_reference(*args, relu=relu)
    for g_, w_ in zip(got, want):
        # the kernel's GAP is a fixed-order tree, torch's mean another order
        # (tests/test_pallas.py's tolerance)
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_epilogue_rejects_mixed_devices(cuda):
    y = torch.zeros((2, 8, 4, 4), device=cuda)
    k = torch.zeros((1, 8, 4, 4))
    with pytest.raises(ValueError):
        passport_epilogue(y, k, k, torch.zeros(8), torch.ones(8))


# ------------------------------------------------------------------ K1

@pytest.fixture(scope="module")
def sets():
    """The training slice's resident set (12,800 x 32x32x3) and the tests'
    64 x 16x16x3 one, uint8, made on the host."""
    rng = np.random.default_rng(0)
    return {32: torch.from_numpy(rng.integers(0, 256, (12800, 32, 32, 3),
                                              dtype=np.uint8)),
            16: torch.from_numpy(rng.integers(0, 256, (64, 16, 16, 3),
                                              dtype=np.uint8))}


def _extremes(pad):
    """Every extreme draw: offsets 0 and 2*pad, flip off and on, twice."""
    rows = [(oy, ox, f) for oy in (0, 2 * pad) for ox in (0, 2 * pad)
            for f in (0, 1)] * 2
    t = torch.tensor(rows, dtype=torch.int32)
    return tuple(t[:, i].contiguous() for i in range(3))


# (set side, batch, pad, extreme draws): the training batch, batch 1 and
# 13, and the tests' 16x16 shape
AUGMENT_CASES = {"B256": (32, 256, 4, False), "B1": (32, 1, 4, False),
                 "B13": (32, 13, 4, False), "B16_16x16": (16, 16, 2, False),
                 "extremes": (32, 16, 4, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_kernel_matches_plain_version(cuda, sets, case):
    side, b, pad, extreme = AUGMENT_CASES[case]
    ds = sets[side].to(cuda)
    gen = torch.Generator().manual_seed(b)
    idx = torch.randperm(ds.shape[0], generator=gen)[:b].int().to(cuda)
    draws = _extremes(pad) if extreme else draw_augment(gen, b, pad)
    draws = tuple(t.to(cuda) for t in draws)
    for stats, exact in (((torch.zeros(3, device=cuda),
                           torch.ones(3, device=cuda)), True),
                         (scaled_stats(device=cuda), False)):
        before = fused_augment.launches
        got = fused_augment(ds, idx, *draws, *stats, pad)
        torch.cuda.synchronize()
        assert fused_augment.launches == before + 1
        want = augment_reference(ds[idx.long()], *draws, pad, *stats)
        assert got.shape == (b, 3, side, side)
        if exact:  # the gathered, cropped, flipped pixels bit for bit
            assert torch.equal(got, want)
        else:  # tests/test_pallas_augment.py's tolerance
            torch.testing.assert_close(got, want, rtol=0, atol=3e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["mixed_devices", "float_set", "strided"])
def test_augment_wrapper_rejects(cuda, sets, fault):
    ds = sets[16].to(cuda)
    draws = [t.to(cuda) for t in draw_augment(torch.Generator(), 4, 2)]
    args = [ds, torch.arange(4, dtype=torch.int32, device=cuda), *draws,
            *scaled_stats(device=cuda), 2]
    if fault == "mixed_devices":
        args[1] = args[1].cpu()
    elif fault == "float_set":
        args[0] = ds.float()
    else:
        args[0] = ds[:, :, ::2]
    before = fused_augment.launches
    with pytest.raises((TypeError, ValueError)):
        fused_augment(*args)
    assert fused_augment.launches == before


# ---------------------------------------------------------------- train

@pytest.mark.cuda
def test_split_private_train_step_matches_cpu(cuda):
    """One ResNet9 V2 split-private step (K1 on the card, its plain version
    on the CPU) from the same weights and draws; chip_smoke.py's
    card-vs-CPU tolerance (convolutions sum in other orders)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")),
        "bn", "shuffle", 0.1)
    cpu_model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                            input_size=16, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(1)
    batch = {"image": rng.integers(0, 256, (16, 16, 16, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, 16)}
    draws = draw_augment(torch.Generator().manual_seed(2), 16, 2)
    metrics = {}
    for dev, model in (("cpu", cpu_model), (cuda, gpu_model)):
        step = make_train_step(
            model, True, pad=2, device=dev,
            draws=lambda step, n, dev=dev: tuple(t.to(dev) for t in draws))
        _, metrics[str(dev)] = step(TrainState.create(model, 0.01), batch)
    for k, v in metrics["cpu"].items():
        torch.testing.assert_close(metrics["cuda"][k].cpu(), v, rtol=1e-3,
                                   atol=1e-4, msg=k)
    want = cpu_model.state_dict()
    for name, t in gpu_model.state_dict().items():
        torch.testing.assert_close(t.cpu(), want[name], rtol=1e-3, atol=1e-4,
                                   msg=name)
