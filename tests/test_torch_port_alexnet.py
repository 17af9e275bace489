"""The port's AlexNet against the JAX package's on equal weights.

Each JAX AlexNet is initialised by flax, its BN running statistics redrawn
with numpy, and its variables loaded into the port model with
``load_jax_variables`` (which reorders the flattened classifiers' input
rows: JAX flattens NHWC, the port NCHW). Both sides run on the CPU: JAX at
'highest' matmul precision (tests/conftest.py) with the Pallas epilogue off
or in interpret mode, the port through its kernels' plain versions. The
augmentation draws, permutations and dropout masks are JAX's, handed to the
port (W7). Tolerances are those of the ResNet tests
(test_torch_port_model.py, test_torch_port_train.py,
test_torch_port_bf16.py), with the measured worsts beside them.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.interop import surgery as jax_surgery
from deepipr_tpu.models import alexnet as jax_alexnet
from deepipr_tpu.models.branching import branch_point as jax_branch_point
from deepipr_tpu.ops.pooling import adaptive_avg_pool2d as jax_adaptive_pool
from deepipr_tpu.train import keys as jax_keys
from deepipr_tpu.train.epoch import make_epoch_train_fn as jax_epoch_fn
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.train.steps import (
    make_dual_eval_step as jax_dual_eval_step,
    run_dual_eval as jax_run_dual_eval,
    test_signature as jax_test_signature,
)
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.interop import surgery
from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models import alexnet
from deepipr_tpu_torch.models.branching import branch_point
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.pooling import adaptive_avg_pool2d
from deepipr_tpu_torch.serve import Predictor, verify_ownership
from deepipr_tpu_torch.train import keys
from deepipr_tpu_torch.train.epoch import device_resident, make_epoch_train_fn
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import (
    make_dual_eval_step,
    make_train_step,
    run_dual_eval,
    seeded_dropout,
)

from test_torch_port_augment import jax_draws, port_draws
from test_torch_port_bf16 import LOGITS_TOL as BF16_LOGITS_TOL
from test_torch_port_bf16 import SCALE_TOL as BF16_SCALE_TOL
from test_torch_port_experiment import PASSPORT_TOL
from test_torch_port_model import (
    CONFIGS,
    LOGITS_TOL,
    RNGS,
    SCALE_TOL,
    jax_epilogue,
    nchw,
    numpy_variables,
)
from test_torch_port_train import MOMENTUM_NORM_TOL, PARAM_TOL

SIDE = 32  # the CIFAR variant's classifier reads a 4x4 map: 32x32 inputs
BF16 = torch.bfloat16
# scheme: (passport config, private), alexnet_passport.json (features_4, 5
# and 6) as the CLIs' default
SCHEMES = {"normal": (None, False), "v1": ("alexnet_passport.json", False),
           "v2": ("alexnet_passport.json", True)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread, as the other port test files: the tier-1 run
    puts several pytest workers on the same cores. Module-scoped, so that
    it is in place before the module's other fixtures train models."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kwargs(config, key_type="random"):
    if config is None:
        return None
    return construct_passport_kwargs(
        load_passport_config(str(CONFIGS / config)), "bn", key_type, 0.1)[0]


def alexnet_pair(scheme, num_classes=10, imagenet=False, side=SIDE,
                 dtype=None, seed=0):
    """(JAX model, numpy variables, port model on the CPU) on equal
    weights."""
    config, private = SCHEMES[scheme]
    kw = _kwargs(config)
    jmodel = jax_alexnet.AlexNet(
        num_classes=num_classes, passport_kwargs=kw, private=private,
        imagenet=imagenet, dtype=None if dtype is None else jnp.bfloat16)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((2, side, side, 3)),
                                    train=True), seed)
    pmodel = build_model("alexnet", num_classes, passport_kwargs=kw,
                         private=private, imagenet=imagenet, input_size=side,
                         dtype=dtype, device="cpu")
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


@pytest.fixture(scope="module")
def pairs():
    """alexnet_pair by its arguments, each built once per module."""
    cache = {}

    def get(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in cache:
            cache[key] = alexnet_pair(*args, **kwargs)
        return cache[key]

    return get


def _images(n, side=SIDE, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, side, side, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


# ------------------------------------------------------------- pooling

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(4, 4), (13, 13), (6, 6), (5, 7)])
def test_adaptive_avg_pool2d_matches_jax(hw, dtype):
    """F.adaptive_avg_pool2d takes the JAX function's windows, including
    the 4 -> 6 of the 10-class ImageNet head, where windows repeat rows.
    f32: rtol 1e-6 (a mean of up to 9 values summed in another order;
    measured worst 6.0e-8 absolute, at 13 -> 6); bf16: 1 bf16 ulp (both
    round one f32 mean; measured equal)."""
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax_adaptive_pool(jx, (6, 6)).astype(jnp.float32))
    got = adaptive_avg_pool2d(nchw(x).to(getattr(torch, dtype)), (6, 6))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy().transpose(0, 2, 3, 1)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" \
        else dict(rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(got, want, **tol)


# ------------------------------------------------------------ the model

# (scheme, ind, JAX epilogue mode)
CIFAR_CASES = [("normal", 0, "off"), ("v1", 0, "off"), ("v1", 0, "interpret"),
               ("v2", 0, "off"), ("v2", 1, "off"), ("v2", 1, "interpret")]


@pytest.mark.parametrize("scheme,ind,mode", CIFAR_CASES)
def test_cifar_logits_match_jax(pairs, scheme, ind, mode):
    """The CIFAR variant at LOGITS_TOL (measured worst 1.9e-6 absolute on
    logits up to 2.8)."""
    jmodel, v, pmodel = pairs(scheme)
    x, _ = _images(2)
    with jax_epilogue(mode):
        jl = jmodel.apply(v, jnp.asarray(x), ind=ind, train=False)
    with torch.inference_mode():
        out = pmodel(nchw(x), ind=ind)
    assert out.logits.shape == (2, 10) and out.tap is None
    assert sorted(out.aux) == ([] if scheme == "normal" or ind == 0 and
                               scheme == "v2" else
                               ["features_4", "features_5", "features_6"])
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jl),
                               **LOGITS_TOL)


@pytest.mark.parametrize("scheme", ["v1", "v2"])
def test_derived_scales_match_jax_sign_for_sign(pairs, scheme):
    jmodel, v, pmodel = pairs(scheme)
    private = scheme == "v2"
    shape = (1, SIDE, SIDE, 3)
    jaff = jax_derived_affines(jmodel, v, shape, private=private)
    paff = derived_affines(pmodel, shape, private=private)
    assert sorted(paff) == sorted(jaff) == ["features_4", "features_5",
                                            "features_6"]
    for path in jaff:
        js = np.asarray(jaff[path]["scale"])
        ps = paff[path]["scale"].numpy()
        np.testing.assert_allclose(ps, js, **SCALE_TOL)
        np.testing.assert_array_equal(np.sign(ps), np.sign(js))


# (num_classes, imagenet, input side): the full ImageNet variant at 224 px
# (13x13 maps at features_4-6), and the reference's quirk: imagenet=True
# with 10 classes keeps the CIFAR convs under the MLP head, pooling a 4x4
# map up to 6x6
IMAGENET_CASES = {"imagenet1000": (1000, False, 224),
                  "imagenet_quirk": (10, True, SIDE)}


@pytest.mark.parametrize("ind", [0, 1])
@pytest.mark.parametrize("case", sorted(IMAGENET_CASES))
def test_imagenet_variants_match_jax(pairs, case, ind):
    """V2 at batch 2, eval (dropout off), at LOGITS_TOL (measured worst
    2.4e-6 absolute at 1000 classes, on logits up to 3.1)."""
    num_classes, imagenet, side = IMAGENET_CASES[case]
    jmodel, v, pmodel = pairs("v2", num_classes=num_classes,
                              imagenet=imagenet, side=side)
    assert pmodel.head_imagenet
    assert tuple(pmodel.classifier_1.weight.shape) == (4096, 9216)
    hw = 13 if num_classes == 1000 else 8
    assert tuple(pmodel.features_4.key.shape) == (1, 192, hw, hw)
    x, _ = _images(2, side)
    jl = jmodel.apply(v, jnp.asarray(x), ind=ind, train=False)
    with torch.inference_mode():
        pl = pmodel(nchw(x), ind=ind).logits
    assert pl.shape == (2, num_classes)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)


@pytest.mark.parametrize("case", sorted(IMAGENET_CASES) + ["cifar"])
def test_flattened_classifier_reorder_is_needed(pairs, case):
    """A plain-transpose load of the Dense kernel that reads the flattened
    map gives other logits: the (h, w, c) -> (c, h, w) reorder of
    interop/jax_params.py is what makes the port agree with JAX."""
    if case == "cifar":
        num_classes, imagenet, side, name = 10, False, SIDE, "classifier"
    else:
        num_classes, imagenet, side = IMAGENET_CASES[case]
        name = "classifier_1"
    jmodel, v, pmodel = pairs("v2", num_classes=num_classes,
                              imagenet=imagenet, side=side)
    x, _ = _images(2, side)
    jl = np.asarray(jmodel.apply(v, jnp.asarray(x), ind=1, train=False))
    plain = {k: torch.from_numpy(a) for k, a in jax_state_dict(v).items()}
    plain[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
        v["params"][name]["kernel"].T))
    model = build_model("alexnet", num_classes, passport_kwargs=_kwargs(
        "alexnet_passport.json"), private=True, imagenet=imagenet,
        input_size=side, device="cpu")
    model.load_state_dict(plain)
    with torch.inference_mode():
        wrong = model(nchw(x), ind=1).logits.numpy()
        right = pmodel(nchw(x), ind=1).logits.numpy()
    np.testing.assert_allclose(right, jl, **LOGITS_TOL)
    assert np.abs(wrong - jl).max() > 100 * LOGITS_TOL["atol"]


@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scheme", ["normal", "v1", "v2", "v3"])
@pytest.mark.parametrize("variant", ["cifar", "imagenet"])
def test_build_model_every_scheme_variant_and_dtype(variant, scheme, dtype):
    """build_model('alexnet', ...) for each scheme (V3 is V2's model), on
    both variants, in f32 and bf16: f32 logits of the expected shape from
    both branches, the blocks in the compute dtype."""
    config, private = SCHEMES["v2" if scheme == "v3" else scheme]
    num_classes, side = (1000, 224) if variant == "imagenet" else (10, SIDE)
    model = build_model("alexnet", num_classes, passport_kwargs=_kwargs(
        config), private=private, input_size=side, dtype=dtype,
        device="cpu")
    x = torch.from_numpy(_images(1, side)[0]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        for ind in (0, 1):
            logits = model(x, ind=ind).logits
            assert logits.dtype == torch.float32
            assert logits.shape == (1, num_classes)
            assert torch.isfinite(logits).all()
    assert model.features_6.conv.dtype == dtype


def test_an_input_too_small_for_the_variant_raises():
    with pytest.raises(ValueError, match="no map"):
        build_model("alexnet", 1000, input_size=SIDE, device="cpu")


@pytest.mark.parametrize("bf16_ind", [0, 1])
def test_bf16_logits_and_scales_match_jax(pairs, bf16_ind):
    """A bf16 V2 AlexNet at test_torch_port_bf16.py's tolerances (the
    logits' 2e-2 absolute: bf16 ulps of hidden units that XLA and ATen
    round apart; measured worst 6.0e-3), scales sign for sign."""
    jmodel, v, pmodel = pairs("v2", dtype=BF16)
    x, _ = _images(4)
    jl = jmodel.apply(v, jnp.asarray(x), ind=bf16_ind, train=False)
    with torch.inference_mode():
        pl = pmodel(nchw(x), ind=bf16_ind).logits
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **BF16_LOGITS_TOL)
    jaff = jax_derived_affines(jmodel, v, (1, SIDE, SIDE, 3), private=True)
    paff = derived_affines(pmodel, (1, SIDE, SIDE, 3), private=True)
    for path in jaff:
        got, want = paff[path]["scale"].numpy(), np.asarray(
            jaff[path]["scale"])
        np.testing.assert_allclose(got, want, **BF16_SCALE_TOL)
        np.testing.assert_array_equal(np.sign(got), np.sign(want))


@pytest.mark.parametrize("scheme", ["v1", "v2"])
def test_predictor_and_verify_ownership_match_jax(pairs, scheme):
    """Predictor's logits of both branches at LOGITS_TOL (a V1 model takes
    its passports on either), and verify_ownership's per-layer detection
    rates equal to JAX's signature detection on the same weights."""
    jmodel, v, pmodel = pairs(scheme)
    private = scheme == "v2"
    x, _ = _images(2)
    for ind in (0, 1):
        jl = jmodel.apply(v, jnp.asarray(x), ind=ind, train=False)
        pl = Predictor(pmodel, ind=ind, device="cpu").logits(x)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)
    state = JaxTrainState.create(v, optax.sgd(0.1))
    want = jax_test_signature(jmodel, state, (1, SIDE, SIDE, 3), private)
    got = verify_ownership(pmodel, (1, SIDE, SIDE, 3), private,
                           device="cpu")
    prefix = "private_" if private else "public_"
    assert {prefix + k: r for k, r in got["layers"].items()} == want
    assert sorted(got["layers"]) == ["features_4", "features_5",
                                     "features_6"]


# ----------------------------------------------------- split dual eval

BRANCH_CONFIGS = {
    "alexnet_passport": {"0": False, "2": False, "4": True, "5": True,
                         "6": True},
    "from_features_2": {"0": False, "2": True, "4": False, "5": True,
                        "6": False},
    "first_flagged": {"0": True, "2": False, "4": False, "5": False,
                      "6": True},
    "none_flagged": dict.fromkeys(["0", "2", "4", "5", "6"], False),
}


@pytest.mark.parametrize("num_classes", [10, 1000])
@pytest.mark.parametrize("config", sorted(BRANCH_CONFIGS))
def test_branch_point_matches_jax(config, num_classes):
    kw = construct_passport_kwargs(BRANCH_CONFIGS[config], "bn", "random",
                                   0.1)[0]
    jmodel = jax_alexnet.AlexNet(num_classes=num_classes,
                                 passport_kwargs=kw, private=True)
    pmodel = alexnet.AlexNet(num_classes=num_classes, passport_kwargs=kw,
                             private=True,
                             input_size=224 if num_classes == 1000 else 32)
    assert branch_point(pmodel) == jax_branch_point(jmodel)
    if config == "alexnet_passport":
        assert branch_point(pmodel) == ("features_4",
                                        ["features_0", "features_2"])


def _eval_batches():
    x, y = _images(4, seed=5)
    return [{"image": x[i:i + 2], "label": y[i:i + 2]} for i in (0, 2)]


def test_dual_eval_matches_jax(pairs):
    jmodel, v, pmodel = pairs("v2")
    state = JaxTrainState.create(v, optax.sgd(0.1))
    jres = jax_run_dual_eval(jax_dual_eval_step(jmodel), state, [
        {k: jnp.asarray(a) for k, a in b.items()} for b in _eval_batches()])
    pres = run_dual_eval(make_dual_eval_step(pmodel, device="cpu"),
                         _eval_batches())
    assert sorted(pres) == sorted(jres)
    for k in jres:
        np.testing.assert_allclose(pres[k], jres[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["cifar", "imagenet_quirk"])
def test_split_dual_eval_equals_two_full_forwards(pairs, case):
    """The prefix (features_0, features_2 and their pools) runs once and the
    private branch starts at features_4 from the tap: the same computation
    as two full forwards, bit for bit."""
    imagenet = case != "cifar"
    _, _, pmodel = pairs("v2", imagenet=imagenet)
    split = make_dual_eval_step(pmodel, device="cpu")
    full = make_dual_eval_step(pmodel, split_branches=False, device="cpu")
    batch = _eval_batches()[0]
    a, b = split(batch), full(batch)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    x = nchw(batch["image"])
    with torch.inference_mode():
        tap = pmodel(x, ind=0, tap_at="features_4").tap
    assert tuple(tap.shape) == (2, 192, 8, 8)  # after features_2's pool


# ----------------------------------------------------- training vs JAX

PAD, BATCH, LR = 4, 8, 0.01


def _jax_perm_and_draws(key, n):
    aug_root = jax.random.key(1)  # make_train_step's root for seed 0

    def draws(step, m):
        return port_draws(*jax_draws(jax.random.fold_in(aug_root, step), m,
                                     PAD))

    return torch.from_numpy(np.array(jax.random.permutation(key, n))), draws


def _assert_state_matches(pmodel, pstate, jstate, param_tol):
    params = dict(pmodel.named_parameters())
    want = jax_state_dict({"params": jstate.params})
    assert sorted(want) == sorted(params)
    for name, w in want.items():
        got = params[name].detach().numpy()
        if "norm" in param_tol:
            err = np.linalg.norm(got - w) / np.linalg.norm(w)
            assert err <= param_tol["norm"], (name, err)
        else:
            np.testing.assert_allclose(got, w, err_msg=name, **param_tol)
    buffers = dict(pmodel.named_buffers())
    for name, w in jax_state_dict({"batch_stats": jstate.batch_stats}
                                  ).items():
        np.testing.assert_allclose(buffers[name].numpy(), w, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name, w in jax_state_dict({"params": jstate.opt_state[1].trace}
                                  ).items():
        got = pstate.optimizer.state[params[name]]["momentum_buffer"].numpy()
        err = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert err <= MOMENTUM_NORM_TOL, (name, err)


@pytest.mark.parametrize("scheme", ["v1", "v2"])
def test_two_epoch_steps_match_jax(scheme):
    """Two device-resident steps of batch 8 over a set of 16 (V1, and the
    split V2 step with the EMA re-applied to features_0 and features_2), from
    equal weights with JAX's permutation and crop/flip draws: metrics and BN
    statistics at rtol 1e-4 / atol 1e-5, parameters at PARAM_TOL, momentum
    within MOMENTUM_NORM_TOL of its norm. Measured worst: V1, parameters
    2.5e-6 beyond rtol and momentum 8.9e-4 of its norm; V2, parameters
    1.8e-4 beyond rtol (features_0's kernel, 1.1e-3 of its norm) and
    momentum 8.6e-3 of its norm, where a ReLU kink flips between XLA and
    ATen (test_torch_port_train.py, PARAM_TOL) and moves every gradient
    below it."""
    jmodel, v, pmodel = alexnet_pair(scheme, seed=1)
    private = scheme == "v2"
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (16, SIDE, SIDE, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 16).astype(np.int32)
    key = jax.random.key(3)

    jfn = jax_epoch_fn(jmodel, private, BATCH, PAD)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(LR))
    jstate, jm = jfn(jstate, jnp.asarray(x), jnp.asarray(y), key)

    perm, draws = _jax_perm_and_draws(key, 16)
    pfn = make_epoch_train_fn(pmodel, private, BATCH, PAD, draws=draws,
                              device="cpu")
    pstate = TrainState.create(pmodel, LR)
    pstate, pm = pfn(pstate, *device_resident(x, y, "cpu"), 0, perm=perm)
    if private:
        assert branch_point(pmodel)[1] == ["features_0", "features_2"]
    assert pstate.step == 2 and int(jstate.step) == 2
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _assert_state_matches(pmodel, pstate, jstate, PARAM_TOL)


def jax_dropout_masks(jmodel, variables, n, side, step, seed=0):
    """The keep masks of JAX's train step ``step`` (its dropout key is
    ``fold_in(key(0), step)`` at seed 0, steps.py:112-117, 157), in the
    port's layout: one train-mode apply with the same key, each nn.Dropout
    intercepted and run on ones, whose kept units come out as 2. The masks
    depend on the key, the module path and the shape alone, so every
    forward of that step draws these. The first mask covers the flattened
    6x6x256 map, in JAX's (h, w, c) order: it is reordered to the port's
    (c, h, w), as the Dense kernel after it is."""
    masks = []

    def record(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        kept = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
        masks.append(np.array(kept))
        return jnp.where(kept, x / alexnet.DROPOUT_KEEP, 0)

    rngs = {"dropout": jax.random.fold_in(jax.random.key(0), step)}
    assert seed == 0
    with nn.intercept_methods(record):
        jmodel.apply(variables, jnp.zeros((n, side, side, 3)), train=True,
                     rngs=rngs, mutable=["batch_stats", "passport_aux"])
    hwc, hidden = masks
    chw = hwc.reshape(n, *alexnet.HEAD_POOL, -1).transpose(0, 3, 1, 2)
    return [np.ascontiguousarray(chw.reshape(n, -1)), hidden]


def test_imagenet_head_train_step_with_jax_dropout_masks():
    """One split V2 step of the 10-class ImageNet head (its MLP and two
    dropouts) with JAX's draws and dropout masks, both branches under the
    same masks, as JAX's: at the tolerances of test_two_epoch_steps_match_jax
    (measured worst: parameters 1.3e-8 beyond rtol, momentum below 1e-4 of
    its norm)."""
    jmodel, v, pmodel = alexnet_pair("v2", imagenet=True, seed=2)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (BATCH, SIDE, SIDE, 3)).astype(np.uint8)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    masks = jax_dropout_masks(jmodel, v, BATCH, SIDE, step=0)
    assert [m.shape for m in masks] == pmodel.dropout_shapes(BATCH)
    assert 0.3 < np.mean(masks[1]) < 0.7

    jfn = jax_epoch_fn(jmodel, True, BATCH, PAD)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(LR))
    key = jax.random.key(4)
    jstate, jm = jfn(jstate, jnp.asarray(x), jnp.asarray(y), key)
    perm, draws = _jax_perm_and_draws(key, BATCH)
    asked = []

    def dropout(step, shapes):
        asked.append((step, [tuple(s) for s in shapes]))
        return [torch.from_numpy(m) for m in masks]

    pfn = make_epoch_train_fn(pmodel, True, BATCH, PAD, draws=draws,
                              dropout=dropout, device="cpu")
    pstate = TrainState.create(pmodel, LR)
    pstate, pm = pfn(pstate, *device_resident(x, y, "cpu"), 0, perm=perm)
    assert asked == [(0, [(BATCH, 9216), (BATCH, 4096)])]
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _assert_state_matches(pmodel, pstate, jstate, PARAM_TOL)


def test_dropout_masks_depend_on_seed_and_step_alone():
    cpu = torch.device("cpu")
    shapes = [(4, 9216), (4, 4096)]
    a, again = seeded_dropout(0, cpu), seeded_dropout(0, cpu)
    torch.manual_seed(123)  # the global generator plays no part
    for m, n in zip(a(3, shapes), again(3, shapes)):
        assert m.dtype == torch.bool and torch.equal(m, n)
    assert not torch.equal(a(3, shapes)[0], a(4, shapes)[0])
    assert not torch.equal(a(3, shapes)[0], seeded_dropout(1, cpu)(3,
                                                                  shapes)[0])
    keep = torch.cat([m.ravel() for m in a(5, shapes)]).float().mean()
    assert abs(keep.item() - alexnet.DROPOUT_KEEP) < 0.02


def test_train_mode_imagenet_head_needs_masks():
    model = build_model("alexnet", 10, imagenet=True, device="cpu").train()
    x = torch.zeros(2, 3, SIDE, SIDE)
    with pytest.raises(ValueError, match="dropout_masks"):
        model(x)
    with pytest.raises(ValueError, match="dropout mask"):
        model(x, dropout_masks=[torch.ones(2, 9216, dtype=torch.bool),
                                torch.ones(2, 4095, dtype=torch.bool)])
    # the CIFAR head has no dropout; the default step draws its own masks
    cifar = build_model("alexnet", 10, device="cpu")
    assert cifar.dropout_shapes(2) == []
    step = make_train_step(model, False, device="cpu")
    state, metrics = step(TrainState.create(model, LR), {
        "image": np.zeros((2, SIDE, SIDE, 3), np.float32),
        "label": np.zeros(2, np.int32)})
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))


# ------------------------------------------------- keys and surgery

def test_setup_passports_matches_jax_on_equal_weights(pairs):
    """Passports for features_4-6 from a scheme-0 AlexNet's taps (the
    inputs of those blocks, after the pools), selected as JAX selects
    them, at the ResNet's PASSPORT_TOL (taps after train-mode BN, summed in
    other orders)."""
    jmodel, v, pmodel = pairs("normal")
    images = _images(40, seed=6)[0]
    kx = keys.sample_candidates(images, 20, seed=10)
    ky = keys.sample_candidates(images, 20, seed=11)
    kw = _kwargs("alexnet_passport.json", "shuffle")
    jtarget = jax_alexnet.AlexNet(num_classes=10, passport_kwargs=kw,
                                  private=True)
    jpass = jtarget.init(RNGS, jnp.zeros((1, SIDE, SIDE, 3)),
                         train=True)["passport"]
    want = jax_state_dict({"passport": jax.tree.map(
        np.asarray, jax_keys.setup_passports(jmodel, v, jpass, kx, ky,
                                             seed=12))})
    target = build_model("alexnet", 10, passport_kwargs=kw, private=True,
                         device="cpu")
    got = keys.setup_passports(pmodel, target, kx, ky, seed=12)
    assert sorted(got) == sorted(want) == [
        f"features_{i}.{k}" for i in (4, 5, 6) for k in ("key", "skey")]
    assert tuple(got["features_5.key"].shape) == (1, 384, 8, 8)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name,
                                   **PASSPORT_TOL)


def test_surgery_matches_jax(pairs):
    """passport_to_normal, normal_to_normal and copy_matching on AlexNet:
    the normal model built from the V2 model's derived affines, and the
    last classifier found as JAX finds it (``classifier`` on CIFAR,
    ``classifier_6`` under the ImageNet head)."""
    jmodel, v, pmodel = pairs("v2")
    plpaths = ["features_4", "features_5", "features_6"]
    jnormal = jax_alexnet.AlexNet(num_classes=10, norm_type="gn")
    nv = jnormal.init({"params": jax.random.key(5)},
                      jnp.zeros((1, SIDE, SIDE, 3)), train=True)
    jderived = jax_derived_affines(jmodel, v, (1, SIDE, SIDE, 3), True)
    jparams, _ = jax_surgery.passport_to_normal(
        v["params"], v["batch_stats"], jderived, nv["params"], {}, plpaths)
    pnormal = build_model("alexnet", 10, norm_type="gn", device="cpu")
    load_jax_variables(pnormal, jax.tree.map(np.asarray, dict(nv)))
    got = surgery.passport_to_normal(
        pmodel.state_dict(), derived_affines(pmodel, (1, SIDE, SIDE, 3),
                                             True),
        pnormal.state_dict(), plpaths)
    want = jax_state_dict({"params": jax.tree.map(np.asarray, jparams)})
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3, atol=1e-5,
                                   err_msg=k)

    _, _, quirk = pairs("v2", imagenet=True)
    names = list(quirk.state_dict())
    assert surgery._last_classifier_module(names) == \
        jax_surgery._last_classifier_module(n.replace(".", "/")
                                            for n in names) == "classifier_6"
    assert surgery._last_classifier_module(pnormal.state_dict()) == \
        "classifier"
    moved = surgery.normal_to_normal(pnormal.state_dict(),
                                     build_model("alexnet", 10, norm_type="gn",
                                                 seed=9,
                                                 device="cpu").state_dict())
    assert torch.equal(moved["features_6.conv.weight"],
                       pnormal.state_dict()["features_6.conv.weight"])
    assert not torch.equal(moved["classifier.weight"],
                           pnormal.state_dict()["classifier.weight"])
