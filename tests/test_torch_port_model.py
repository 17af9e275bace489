"""The port's blocks and ResNet against the JAX package on the same weights.

Each JAX model is initialised by flax, its BN running statistics are redrawn
with numpy (so BN is not the identity), and the variable tree is loaded into
the port model with ``load_jax_variables``. Both sides then run on the CPU:
JAX at 'highest' matmul precision (tests/conftest.py), with the Pallas
epilogue off or in interpret mode; the port with its plain versions.
"""

import contextlib
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.models import layers as jax_layers
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.models.branching import branch_point as jax_branch_point
from deepipr_tpu.ops.pallas_fused import epilogue_mode, set_epilogue_mode
from deepipr_tpu.train.state import TrainState
from deepipr_tpu.train.steps import (
    collect_aux,
    make_dual_eval_step as jax_dual_eval_step,
    run_dual_eval as jax_run_dual_eval,
)
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.interop.jax_params import load_jax_variables
from deepipr_tpu_torch.models import layers
from deepipr_tpu_torch.models.branching import branch_point
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.train.steps import make_dual_eval_step, run_dual_eval

CONFIGS = Path(__file__).resolve().parents[1] / "passport_configs"
RNGS = {"params": jax.random.key(0), "passport": jax.random.key(1)}

# Whole-model logits: rtol 1e-3 / atol 2e-4, the tolerance
# tests/test_torch_export.py:102 holds torch logits to. Block outputs:
# rtol/atol 1e-5, TestIntegratedEpilogue's in tests/test_pallas.py. Derived
# scales: rtol 1e-3 / atol 1e-5 as tests/test_torch_export.py:115, and their
# signs exactly. Every gap is a difference in summation order (XLA's and
# torch's convolutions and reductions on the CPU).
LOGITS_TOL = dict(rtol=1e-3, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE_TOL = dict(rtol=1e-3, atol=1e-5)


@contextlib.contextmanager
def jax_epilogue(mode):
    """Run JAX with the Pallas epilogue in ``mode``, then restore the mode."""
    prev = epilogue_mode()
    set_epilogue_mode(mode)
    try:
        yield
    finally:
        set_epilogue_mode(prev)


def numpy_variables(variables, seed):
    """The flax variable tree as numpy, BN running stats redrawn with numpy:
    mean ~ N(0, 1), var ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def redraw(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = redraw(v)
            elif k == "mean":
                out[k] = rng.normal(size=v.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return out

    tree = jax.tree.map(np.asarray, dict(variables))
    if "batch_stats" in tree:
        tree["batch_stats"] = redraw(tree["batch_stats"])
    return tree


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def resnet_pair(arch, config, size, seed=0, num_classes=10):
    """(JAX model, numpy variables, port model on the CPU) on equal weights.

    ``config``: a file of passport_configs/, or the config itself."""
    if isinstance(config, str):
        config = load_passport_config(str(CONFIGS / config))
    kw, _ = construct_passport_kwargs(config, "bn", "random", 0.1)
    make = {"resnet9": jax_resnet.ResNet9, "resnet18": jax_resnet.ResNet18}[arch]
    jmodel = make(num_classes=num_classes, passport_kwargs=kw, private=True)
    v = jmodel.init(RNGS, jnp.zeros((2, size, size, 3)), train=True)
    v = numpy_variables(v, seed)
    pmodel = build_model(arch, num_classes, passport_kwargs=kw, private=True,
                         input_size=size, device="cpu")
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


# ----------------------------------------------------------------- blocks

BLOCK_CASES = {
    # name: (port/JAX block kwargs, call kwargs)
    "private_ind0": ("private", {}, {"ind": 0}),
    "private_ind1": ("private", {}, {"ind": 1}),
    "private_force": ("private", {}, {"ind": 0, "force_passport": True}),
    "private_separate_stats": ("private", {"separate_stats": True}, {"ind": 1}),
    "private_gn": ("private", {"norm_type": "gn"}, {"ind": 1}),
    "private_in": ("private", {"norm_type": "in"}, {"ind": 1}),
    "v1": ("v1", {}, {}),
    "v1_learnable": ("v1", {"learnable_affine": True}, {}),
    "v1_learnable_forced": ("v1", {"learnable_affine": True},
                            {"force_passport": True}),
}


def _block_pair(case):
    kind, extra, call = BLOCK_CASES[case]
    kwargs = {"norm_type": "bn", "alpha": 0.1, "b_spec": 7, **extra}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    jcls = jax_layers.PassportPrivateBlock if kind == "private" \
        else jax_layers.PassportBlock
    pcls = layers.PassportPrivateBlock if kind == "private" \
        else layers.PassportBlock
    jblock = jcls(features=256, **kwargs)
    v = numpy_variables(jblock.init(RNGS, jnp.asarray(x), train=True), seed=1)
    pblock = pcls(16, 256, input_hw=(4, 4), **kwargs).eval()
    load_jax_variables(pblock, v)
    return jblock, v, pblock, x, call


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_matches_jax(case, mode):
    jblock, v, pblock, x, call = _block_pair(case)
    with jax_epilogue(mode):
        jy, upd = jblock.apply(v, jnp.asarray(x), train=False,
                               mutable=["passport_aux"], **call)
    jaux = collect_aux(upd)
    with torch.inference_mode():
        y, aux = pblock(nchw(x), **call)
    np.testing.assert_allclose(to_nhwc(y), np.asarray(jy), **BLOCK_TOL)
    assert (aux is None) == (not jaux)
    if aux is not None:
        for k in ("scale", "bias"):
            # TestIntegratedEpilogue's scale/bias tolerance (test_pallas.py)
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[0][k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(aux["b"].numpy(),
                                      np.asarray(jaux[0]["b"]))


# ------------------------------------------------------------ whole model

@pytest.fixture(scope="module")
def resnet9():
    return resnet_pair("resnet9", "resnet9_passport.json", 16)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    return x, y


@pytest.mark.parametrize("mode", ["off", "interpret"])
@pytest.mark.parametrize("ind", [0, 1])
def test_resnet9_logits_match_jax(resnet9, images, ind, mode):
    jmodel, v, pmodel = resnet9
    x = images[0][:2]
    with jax_epilogue(mode):
        jl = jmodel.apply(v, jnp.asarray(x), ind=ind, train=False)
    with torch.inference_mode():
        pl = pmodel(nchw(x), ind=ind).logits
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)


def test_resnet9_derived_scales_match_jax_sign_for_sign(resnet9):
    jmodel, v, pmodel = resnet9
    jaff = jax_derived_affines(jmodel, v, (1, 16, 16, 3), private=True)
    paff = derived_affines(pmodel, (1, 16, 16, 3), private=True)
    assert sorted(paff) == sorted(jaff) == [
        "layer4_0/convbn_2", "layer4_0/convbnrelu_1", "layer4_0/shortcut"]
    for path in jaff:
        js = np.asarray(jaff[path]["scale"])
        ps = paff[path]["scale"].numpy()
        np.testing.assert_allclose(ps, js, **SCALE_TOL)
        np.testing.assert_array_equal(np.sign(ps), np.sign(js))


def test_resnet9_branch_point_matches_jax(resnet9):
    jmodel, _, pmodel = resnet9
    assert branch_point(pmodel) == jax_branch_point(jmodel)
    assert branch_point(pmodel)[0] == "layer4_0"


def _batches(images):
    x, y = images
    return [{"image": x[i:i + 2], "label": y[i:i + 2]} for i in (0, 2)]


def test_resnet9_dual_eval_matches_jax(resnet9, images):
    jmodel, v, pmodel = resnet9
    state = TrainState.create(v, optax.sgd(0.1))
    jstep = jax_dual_eval_step(jmodel)
    pstep = make_dual_eval_step(pmodel, device="cpu")
    for batch in _batches(images):
        jout = jstep(state, {k: jnp.asarray(a) for k, a in batch.items()})
        pout = pstep(batch)
        assert sorted(pout) == sorted(jout)
        for k in jout:
            if k.startswith("correct"):
                assert int(pout[k]) == int(jout[k]), k
            else:
                # a sum of per-image CEs over logits held at LOGITS_TOL
                np.testing.assert_allclose(float(pout[k]), float(jout[k]),
                                           rtol=1e-3, atol=1e-3)
    jres = jax_run_dual_eval(jstep, state, [
        {k: jnp.asarray(a) for k, a in b.items()} for b in _batches(images)])
    pres = run_dual_eval(pstep, _batches(images))
    assert sorted(pres) == sorted(jres)
    for k in jres:
        np.testing.assert_allclose(pres[k], jres[k], rtol=1e-3, atol=1e-3)


def test_split_dual_eval_equals_two_full_forwards(resnet9, images):
    _, _, pmodel = resnet9
    split = make_dual_eval_step(pmodel, device="cpu")
    full = make_dual_eval_step(pmodel, split_branches=False, device="cpu")
    batch = _batches(images)[0]
    a, b = split(batch), full(batch)
    for k in a:
        # the prefix is the same computation either way
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ------------------------------------------------------------- the loader

@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "collection"])
def test_load_jax_variables_is_strict(resnet9, fault):
    _, v, _ = resnet9
    bad = jax.tree.map(lambda a: a, v)  # a copy of the nested dicts
    if fault == "missing":
        del bad["passport"]["layer4_0"]["shortcut"]["skey"]
    elif fault == "extra":
        bad["batch_stats"]["layer4_0"]["convbn_2"]["bn_private"] = {
            "mean": np.zeros(512, np.float32), "var": np.ones(512, np.float32)}
    elif fault == "shape":
        bad["signature"]["layer4_0"]["convbn_2"]["b"] = np.ones(3, np.float32)
    else:
        bad["passport_aux"] = {}
    target = build_model("resnet9", 10, device="cpu", input_size=16,
                         passport_kwargs=construct_passport_kwargs(
                             load_passport_config(
                                 str(CONFIGS / "resnet9_passport.json")),
                             "bn", "random", 0.1)[0],
                         private=True)
    with pytest.raises(ValueError):
        load_jax_variables(target, bad)


def test_load_jax_variables_rejects_a_model_without_passports(resnet9):
    _, v, _ = resnet9
    normal = build_model("resnet9", 10, input_size=16, device="cpu")
    with pytest.raises(ValueError):
        load_jax_variables(normal, v)
