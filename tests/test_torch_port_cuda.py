"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Without a CUDA card each test skips: a CUDA kernel has no CPU mode, and the
CPU tests hold the plain versions to the JAX package instead
(tests/test_torch_port_kernels.py).
"""

import pytest
import torch

from deepipr_tpu_torch.ops.passport_epilogue import (
    passport_epilogue,
    passport_epilogue_reference,
)


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
