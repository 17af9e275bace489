"""Kernel K1's plain version (data/device_augment.py, ops/fused_augment.py)
against the JAX package's input stage, and one device-resident epoch
(train/epoch.py) against JAX's with ``input_stage="pallas"``.

On the CPU the wrapper ``fused_augment`` takes the plain version, so these
tests hold that version to the Pallas kernel (run in interpret mode) and to
the XLA paths; the CUDA kernel is held to the plain version on the card
(tests/test_torch_port_cuda.py and ``chip_smoke.py``). The draws are made
with JAX's split pattern and handed to the port (W7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepipr_tpu.data.device_augment import (
    make_device_augment as jax_device_augment,
    normalize_device as jax_normalize_device,
)
from deepipr_tpu.ops.pallas_augment import make_pallas_augment
from deepipr_tpu.train.epoch import make_epoch_train_fn as jax_epoch_fn
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState

from deepipr_tpu_torch.data.device_augment import (
    augment_reference,
    draw_augment,
    make_device_augment,
    normalize_device,
    scaled_stats,
)
from deepipr_tpu_torch.interop.jax_params import jax_state_dict
from deepipr_tpu_torch.ops.fused_augment import fused_augment
from deepipr_tpu_torch.train.epoch import (
    device_resident,
    epoch_permutation,
    make_epoch_train_fn,
)
from deepipr_tpu_torch.train.state import TrainState

from test_torch_port_model import resnet_pair

# tests/test_pallas_augment.py's tolerance for the normalized output: the
# Pallas kernel and the port divide by 255*std, XLA multiplies by its
# reciprocal, 1 ulp apart
NORM_TOL = dict(rtol=0, atol=3e-7)
# (pad, side): the training slice's CIFAR shape and the tests' ResNet9 shape
SHAPES = [(4, 32), (2, 16)]
B = 16


def jax_draws(key, n, pad):
    """make_device_augment's draws for ``key`` (device_augment.py:58-84)."""
    kc, kf = jax.random.split(key)
    offs = np.asarray(jax.random.randint(kc, (n, 2), 0, 2 * pad + 1))
    flips = np.asarray(jax.random.bernoulli(kf, 0.5, (n,)))
    return offs, flips


def port_draws(offs, flips):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
                 for a in (offs[:, 0], offs[:, 1], flips))


def jax_slice_augment(x_u8, offs, flips, pad, mean, std):
    """make_device_augment's 'slice' body (device_augment.py:56-86) with the
    draws given instead of drawn."""
    mean = jnp.asarray(mean, jnp.float32) * 255.0
    std = jnp.asarray(std, jnp.float32) * 255.0
    _, h, w, c = x_u8.shape
    xp = jnp.pad(jnp.asarray(x_u8, jnp.float32),
                 ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    x = jax.vmap(lambda img, off: jax.lax.dynamic_slice(
        img, (off[0], off[1], 0), (h, w, c)))(xp, jnp.asarray(offs))
    x = jnp.where(jnp.asarray(flips)[:, None, None, None], x[:, :, ::-1, :], x)
    return np.asarray((x - mean) / std)


def to_nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    out = {}
    for pad, side in SHAPES:
        ds = rng.integers(0, 256, (64, side, side, 3)).astype(np.uint8)
        idx = rng.permutation(64)[:B].astype(np.int32)
        out[side] = ds, idx
    return out


# ------------------------------------------------------------ K1 vs JAX

@pytest.mark.parametrize("pad,side", SHAPES)
@pytest.mark.parametrize("reference", ["pallas", "slice", "onehot"])
def test_plain_version_matches_jax_input_stage(sets, pad, side, reference):
    ds, idx = sets[side]
    key = jax.random.key(7)
    if reference == "pallas":
        pal = make_pallas_augment(pad, height=side, width=side, block=8,
                                  interpret=True)
        want = np.asarray(pal(key, jnp.asarray(ds), jnp.asarray(idx)))
    else:
        want = np.asarray(jax_device_augment(pad, crop_impl=reference)(
            key, jnp.asarray(ds[idx])))
    offs, flips = jax_draws(key, B, pad)
    m, s = scaled_stats()
    got = fused_augment(torch.from_numpy(ds), torch.from_numpy(idx),
                        *port_draws(offs, flips), m, s, pad)
    assert got.shape == (B, 3, side, side) and got.dtype == torch.float32
    np.testing.assert_allclose(to_nhwc(got), want, **NORM_TOL)


@pytest.mark.parametrize("pad,side", SHAPES)
def test_plain_version_pixels_exact(sets, pad, side):
    """mean 0, std 1/255: the gathered, cropped, flipped pixels bit for bit
    (tests/test_pallas_augment.py::test_unnormalized_pixels_exact)."""
    ds, idx = sets[side]
    key = jax.random.key(3)
    zero, unit = np.zeros(3), np.ones(3) / 255.0
    pal = make_pallas_augment(pad, height=side, width=side, block=8,
                              interpret=True, mean=zero, std=unit)
    want = np.asarray(pal(key, jnp.asarray(ds), jnp.asarray(idx)))
    offs, flips = jax_draws(key, B, pad)
    got = make_device_augment(pad, mean=zero, std=unit)(
        port_draws(offs, flips), torch.from_numpy(ds[idx]))
    np.testing.assert_array_equal(to_nhwc(got), want)
    assert want.min() >= 0.0 and want.max() <= 255.0


@pytest.mark.parametrize("pad,side", SHAPES)
@pytest.mark.parametrize("flip", [0, 1])
@pytest.mark.parametrize("offset", ["zero", "max", "mixed"])
def test_extreme_draws_match_jax(sets, pad, side, flip, offset):
    ds, idx = sets[side]
    x = ds[idx]
    oy = {"zero": 0, "max": 2 * pad, "mixed": 0}[offset]
    ox = {"zero": 0, "max": 2 * pad, "mixed": 2 * pad}[offset]
    offs = np.tile(np.asarray([[oy, ox]], np.int32), (B, 1))
    flips = np.full(B, bool(flip))
    for mean, std, tol in ((np.zeros(3), np.ones(3) / 255.0,
                            dict(rtol=0, atol=0)),
                           (np.asarray([0.485, 0.456, 0.406]),
                            np.asarray([0.229, 0.224, 0.225]), NORM_TOL)):
        want = jax_slice_augment(x, offs, flips, pad, mean, std)
        got = make_device_augment(pad, mean=mean, std=std)(
            port_draws(offs, flips), torch.from_numpy(x))
        np.testing.assert_allclose(to_nhwc(got), want, **tol)


def test_normalize_device_matches_jax(sets):
    ds, _ = sets[32]
    want = np.asarray(jax_normalize_device(jnp.asarray(ds[:8])))
    got = normalize_device(torch.from_numpy(ds[:8]))
    np.testing.assert_allclose(to_nhwc(got), want, **NORM_TOL)


# ------------------------------------------------- the wrapper on the CPU

def test_wrapper_takes_plain_version_on_cpu(sets):
    ds, idx = sets[16]
    gen = torch.Generator().manual_seed(0)
    draws = draw_augment(gen, B, 2)
    m, s = scaled_stats()
    before = fused_augment.launches
    got = fused_augment(torch.from_numpy(ds), torch.from_numpy(idx), *draws,
                        m, s, 2)
    want = augment_reference(torch.from_numpy(ds[idx]), *draws, 2, m, s)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_augment.launches == before  # only kernel launches count


@pytest.mark.parametrize("fault", ["dtype", "strided", "index_dtype",
                                   "draw_shape", "stats", "device", "pad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(sets, fault):
    ds, idx = sets[16]
    args = [torch.from_numpy(ds), torch.from_numpy(idx),
            *draw_augment(torch.Generator().manual_seed(0), B, 2),
            *scaled_stats(), 2]
    if fault == "dtype":
        args[0] = args[0].float()
    elif fault == "strided":
        args[0] = args[0][:, :, ::2]
    elif fault == "index_dtype":
        args[1] = args[1].long()
    elif fault == "draw_shape":
        args[2] = args[2][:-1]
    elif fault == "stats":
        args[5] = args[5].double()
    elif fault == "device":
        args[1] = args[1].to("meta")
    else:
        args[7] = -1
    with pytest.raises((TypeError, ValueError)):
        fused_augment(*args)


def test_draws_cover_their_range():
    oy, ox, flip = draw_augment(torch.Generator().manual_seed(1), 4096, 4)
    for t, hi in ((oy, 8), (ox, 8), (flip, 1)):
        assert t.dtype == torch.int32
        assert int(t.min()) == 0 and int(t.max()) == hi
    assert 0.45 < float(flip.float().mean()) < 0.55


def test_epoch_permutation_drops_last_and_rejects_oversized_batch():
    steps, rows = epoch_permutation(torch.randperm(70), 16)
    assert steps == 4 and rows.shape == (4, 16)
    assert len(set(rows.reshape(-1).tolist())) == 64
    with pytest.raises(ValueError, match="exceeds"):
        epoch_permutation(torch.randperm(8), 16)


# ------------------------------------------------------- one epoch vs JAX

@pytest.fixture(scope="module")
def resnet9():
    return resnet_pair("resnet9", "resnet9_passport.json", 16)


def _assert_close(got, want, tol):
    """Per tensor: elementwise ``assert_allclose`` kwargs, or with
    ``{"norm": r}`` the norm-wise bound ||got - want|| <= r * ||want||."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if "norm" in tol:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= tol["norm"], (name, err)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


# (params, BN statistics, momentum) tolerances after the two-step epoch.
# V2 agrees elementwise (measured: params 4.4e-9 and statistics 7.0e-8
# beyond rtol, momentum 3.8e-6 of the norm). V3 is held norm-wise: with the
# trigger rows in the batch, a pre-ReLU value within float32 noise of zero
# lands on opposite sides in XLA and ATen, and the flip moves whole
# gradients (tests/test_torch_port_train.py, PARAM_TOL). The port alone
# moves as far: a 1e-7 relative change of its weights shifts its own
# result by up to 8e-5 elementwise. Measured worst, V3: params 2.3e-2,
# statistics 5.2e-5, momentum 3.5e-2 of each tensor's norm.
EPOCH_TOL = {
    "v2": (dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=1e-5),
           {"norm": 1e-4}),
    "v3": ({"norm": 5e-2}, {"norm": 1e-3}, {"norm": 5e-2}),
}


@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_epoch_matches_jax_pallas_input_stage(resnet9, v3):
    """Two steps of batch 16 over a resident set of 32, V2 and V3 (trigger
    cycling), from equal weights with JAX's permutation and draws."""
    jmodel, v, _ = resnet9
    _, _, pmodel = resnet_pair("resnet9", "resnet9_passport.json", 16)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (32, 16, 16, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 32).astype(np.int32)
    wm_x = rng.integers(0, 256, (6, 16, 16, 3)).astype(np.uint8)
    wm_y = rng.integers(0, 10, 6).astype(np.int32)
    bs, pad, lr = 16, 2, 0.01
    key = jax.random.key(3)
    wm_args = (jnp.asarray(wm_x), jnp.asarray(wm_y)) if v3 else ()

    jfn = jax_epoch_fn(jmodel, True, bs, pad, input_stage="pallas")
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(lr))
    jstate, jm = jfn(jstate, jnp.asarray(x), jnp.asarray(y), key, *wm_args)

    aug_root = jax.random.key(1)  # make_train_step's root for seed 0

    def draws(step, n):
        return port_draws(*jax_draws(jax.random.fold_in(aug_root, step), n,
                                     pad))

    perm = torch.from_numpy(np.array(jax.random.permutation(key, 32)))
    wm_perm = torch.from_numpy(np.array(jax.random.permutation(
        jax.random.fold_in(key, 1), 6)))
    pfn = make_epoch_train_fn(pmodel, True, bs, pad, draws=draws,
                              device="cpu")
    pstate = TrainState.create(pmodel, lr)
    xs, ys = device_resident(x, y, "cpu")
    wms = device_resident(wm_x, wm_y, "cpu") if v3 else (None, None)
    pstate, pm = pfn(pstate, xs, ys, 0, *wms, perm=perm, wm_perm=wm_perm)

    assert pstate.step == 2 and int(jstate.step) == 2
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    param_tol, stat_tol, momentum_tol = EPOCH_TOL["v3" if v3 else "v2"]
    params = dict(pmodel.named_parameters())
    buffers = dict(pmodel.named_buffers())
    _assert_close({k: p.detach().numpy() for k, p in params.items()},
                  jax_state_dict({"params": jstate.params}), param_tol)
    _assert_close({k: buffers[k].numpy() for k in buffers
                   if k.endswith(("_mean", "_var"))},
                  jax_state_dict({"batch_stats": jstate.batch_stats}),
                  stat_tol)
    _assert_close({k: pstate.optimizer.state[p]["momentum_buffer"].numpy()
                   for k, p in params.items()},
                  jax_state_dict({"params": jstate.opt_state[1].trace}),
                  momentum_tol)
