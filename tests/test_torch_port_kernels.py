"""The port's passport-epilogue kernel (ops/passport_epilogue.py) against the
JAX package's Pallas kernel (ops/pallas_fused.py), run in interpret mode.

On the CPU the wrapper takes the kernel's plain PyTorch version, so these
tests hold that version to the Pallas kernel; the CUDA kernel itself is held
to the plain version on the card (tests/test_torch_port_cuda.py and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepipr_tpu.ops.pallas_fused import passport_epilogue_pallas
from deepipr_tpu_torch.ops.passport_epilogue import (
    passport_epilogue,
    passport_epilogue_reference,
)

# NHWC shapes of tests/test_pallas.py:30-38, plus the ResNet-18 layer4 block
# shape of the serving path at batch 2
SHAPES = [(4, 8, 8, 128), (2, 16, 16, 256), (2, 56, 56, 64), (2, 28, 28, 128),
          (2, 4, 4, 512)]


def _inputs(shape, seed=0):
    """NHWC numpy inputs drawn as tests/test_pallas.py draws them."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    y = rng.normal(size=shape).astype(np.float32)
    ko = rng.normal(size=(1, h, w, c)).astype(np.float32)
    so = rng.normal(size=(1, h, w, c)).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return y, ko, so, mean, var


def _nchw(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_plain_version_matches_pallas(shape, relu):
    y, ko, so, mean, var = _inputs(shape)
    j_out, j_scale, j_bias = passport_epilogue_pallas(
        jnp.asarray(y), jnp.asarray(ko), jnp.asarray(so), jnp.asarray(mean),
        jnp.asarray(var), relu=relu, interpret=True)
    out, scale, bias = passport_epilogue_reference(
        _nchw(y), _nchw(ko), _nchw(so), torch.from_numpy(mean),
        torch.from_numpy(var), relu=relu)
    # rtol 1e-5 / atol 1e-6: tests/test_pallas.py's own tolerance; the two
    # GAPs sum the plane in different orders
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               np.asarray(j_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(j_bias[0]),
                               rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_takes_plain_version():
    y, ko, so, mean, var = _inputs((2, 4, 4, 512), seed=1)
    args = (_nchw(y), _nchw(ko), _nchw(so), torch.from_numpy(mean),
            torch.from_numpy(var))
    before = passport_epilogue.launches
    got = passport_epilogue(*args, eps=1e-5, relu=True)
    want = passport_epilogue_reference(*args, eps=1e-5, relu=True)
    assert passport_epilogue.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _bad_inputs(kind):
    y, ko, so, mean, var = _inputs((2, 4, 4, 32), seed=2)
    t = [_nchw(y), _nchw(ko), _nchw(so), torch.from_numpy(mean),
         torch.from_numpy(var)]
    if kind == "f64":
        t[0] = t[0].double()
    elif kind == "key_batch_2":
        t[1] = torch.cat([t[1], t[1]])
    elif kind == "mean_shape":
        t[3] = t[3][:-1]
    elif kind == "not_contiguous":
        t[0] = t[0].transpose(2, 3)
    elif kind == "y_3d":
        t[0] = t[0][0]
    return t


@pytest.mark.parametrize("kind", ["f64", "key_batch_2", "mean_shape",
                                  "not_contiguous", "y_3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises((TypeError, ValueError)):
        passport_epilogue(*_bad_inputs(kind))
