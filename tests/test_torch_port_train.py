"""The port's training slice against the JAX package on the same weights:
sign loss, schedule and SGD, train-mode blocks, and the train step in each
of its four cases over two steps, then the eval entry points after training.

Both sides run on the CPU: JAX at 'highest' matmul precision
(tests/conftest.py), the port through its kernels' plain versions. The
augmentation draws are JAX's, handed to the port (W7).
"""

import importlib

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from deepipr_tpu.data.device_augment import make_device_augment
from deepipr_tpu.models import layers as jax_layers
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.train.schedule import multistep_lr as jax_multistep_lr
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.train.steps import (
    make_dual_eval_step as jax_dual_eval_step,
    make_train_step as jax_train_step,
    test_signature as jax_test_signature,
)
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models import layers
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.norms import BatchNorm
from deepipr_tpu_torch.passport import sign_loss
from deepipr_tpu_torch.train.schedule import multistep_lr
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import (
    make_dual_eval_step,
    make_signature_fn,
    make_train_step,
    seeded_draws,
)

# the module: deepipr_tpu.passport re-exports its functions under its name
jax_sign = importlib.import_module("deepipr_tpu.passport.sign_loss")

from test_torch_port_model import (
    BLOCK_TOL,
    CONFIGS,
    LOGITS_TOL,
    RNGS,
    nchw,
    numpy_variables,
    to_nhwc,
)

PAD, BATCH, SIDE, LR = 2, 16, 16, 0.01


# ------------------------------------------------------------- sign loss

@pytest.fixture(scope="module")
def scales():
    rng = np.random.default_rng(0)
    return [(rng.normal(scale=0.1, size=64).astype(np.float32),
             np.sign(rng.normal(size=64)).astype(np.float32), alpha)
            for alpha in (0.1, 1.0, 0.5)]


def test_sign_loss_and_accuracy_match_jax(scales):
    for s, b, alpha in scales:
        st, bt = torch.from_numpy(s), torch.from_numpy(b)
        np.testing.assert_allclose(
            float(sign_loss.sign_loss(st, bt, alpha)),
            float(jax_sign.sign_loss(jnp.asarray(s), jnp.asarray(b), alpha)),
            rtol=1e-6)
        assert float(sign_loss.sign_accuracy(st, bt)) == float(
            jax_sign.sign_accuracy(jnp.asarray(s), jnp.asarray(b)))


def test_total_sign_loss_matches_jax(scales):
    entries = [{"scale": s, "b": b, "alpha": a} for s, b, a in scales]
    want = jax_sign.total_sign_loss(
        [{k: jnp.asarray(v) if k != "alpha" else v for k, v in e.items()}
         for e in entries])
    got = sign_loss.total_sign_loss(
        [{k: torch.from_numpy(v) if k != "alpha" else v
          for k, v in e.items()} for e in entries])
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    none = sign_loss.total_sign_loss([])
    assert (float(none[0]), float(none[1])) == (0.0, 1.0)


# ------------------------------------------------------- schedule and SGD

def test_multistep_lr_matches_jax():
    cfg = {"type": "steps", "steps": [1, 2], "gamma": 0.1}
    lr, jlr = multistep_lr(0.1, cfg, 2), jax_multistep_lr(0.1, cfg, 2)
    for step in range(6):
        assert lr(step) == pytest.approx(float(jlr(step)))
    assert lr(0) == pytest.approx(0.1)
    assert lr(2) == pytest.approx(0.01)
    assert lr(4) == pytest.approx(0.001)
    const = multistep_lr(0.1, {"type": "steps", "steps": [], "gamma": 0.0}, 2)
    assert const == 0.1
    with pytest.raises(ValueError, match="cosine"):
        multistep_lr(0.1, {"type": "cosine", "steps": [1], "gamma": 0.1}, 2)


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.used = nn.Parameter(torch.tensor([0.5, -1.0, 2.0]))
        self.unused = nn.Parameter(torch.tensor([1.0, -3.0]))


def test_sgd_matches_optax_including_unused_parameters():
    """Decay before momentum, the schedule's step count, and W10: a
    parameter no loss reaches still decays and keeps momentum, as every
    optax leaf does."""
    sched = {"type": "steps", "steps": [1], "gamma": 0.1}
    toy = _Toy()
    state = TrainState.create(toy, multistep_lr(0.1, sched, 2))
    tx = jax_sgd(jax_multistep_lr(0.1, sched, 2))
    params = {"used": jnp.asarray([0.5, -1.0, 2.0]),
              "unused": jnp.asarray([1.0, -3.0])}
    opt = tx.init(params)
    for _ in range(4):
        (toy.used ** 2).sum().backward()
        state.apply_gradients()
        grads = {"used": 2 * params["used"], "unused": jnp.zeros(2)}
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    for name in params:
        np.testing.assert_allclose(getattr(toy, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-6)
        np.testing.assert_allclose(
            state.optimizer.state[getattr(toy, name)]["momentum_buffer"]
            .numpy(), np.asarray(opt[1].trace[name]), rtol=1e-6)
    assert state.step == 4


# ------------------------------------------------------ train-mode blocks

BLOCK_CASES = {
    "conv": ("conv", {}, {}),
    "private_ind0": ("private", {}, {"ind": 0}),
    "private_ind1": ("private", {}, {"ind": 1}),
    "private_separate_stats": ("private", {"separate_stats": True},
                               {"ind": 1}),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_train_mode_block_matches_jax(case):
    kind, extra, call = BLOCK_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    if kind == "conv":
        jblock = jax_layers.ConvBlock(features=256)
        pblock = layers.ConvBlock(16, 256)
    else:
        kw = {"norm_type": "bn", "alpha": 0.1, "b_spec": 7, **extra}
        jblock = jax_layers.PassportPrivateBlock(features=256, **kw)
        pblock = layers.PassportPrivateBlock(16, 256, input_hw=(4, 4), **kw)
    v = numpy_variables(jblock.init(RNGS, jnp.asarray(x), train=True), seed=1)
    load_jax_variables(pblock, v)
    jy, upd = jblock.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats", "passport_aux"], **call)
    y, aux = pblock.train()(nchw(x), **call)
    np.testing.assert_allclose(to_nhwc(y), np.asarray(jy), **BLOCK_TOL)
    want = jax_state_dict({"batch_stats": upd["batch_stats"]})
    got = {k: t.numpy() for k, t in pblock.state_dict().items()
           if k.endswith(("running_mean", "running_var"))}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # the statistics the unused norm keeps are untouched
    moved = [k for k in want if not np.array_equal(
        want[k], jax_state_dict({"batch_stats": v["batch_stats"]})[k])]
    assert moved and all(k.startswith(("bn.", "bn_private."))
                         for k in moved)
    if kind == "private" and call["ind"] == 1:
        np.testing.assert_allclose(
            aux["scale"].detach().numpy(),
            np.asarray(upd["passport_aux"]["aux"][0]["scale"]), rtol=1e-5,
            atol=1e-6)


# -------------------------------------------------- train steps vs JAX

STEP_CASES = {
    # name: (passport config or None, private, split_branches[, norm_type])
    "split_private": ("resnet9_passport.json", True, True),
    "nonsplit_private": ("resnet9_passport.json", True, False),
    "v1": ("resnet9_passport.json", False, True),
    "scheme0": (None, False, True),
    # norm types without BN: the split step's shared prefix then keeps no
    # running statistics to step again (W15)
    "split_private_gn": ("resnet9_passport.json", True, True, "gn"),
    "split_private_in": ("resnet9_passport.json", True, True, "in"),
    "split_private_none": ("resnet9_passport.json", True, True, "none"),
}


def _pair(config, private, norm="bn"):
    kw = None
    if config is not None:
        kw, _ = construct_passport_kwargs(
            load_passport_config(str(CONFIGS / config)), norm, "random", 0.1)
    make = jax_resnet.ResNet9
    jmodel = make(num_classes=10, norm_type=norm, passport_kwargs=kw,
                  private=private)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((2, SIDE, SIDE, 3)),
                                    train=True), seed=0)
    pmodel = build_model("resnet9", 10, norm_type=norm, passport_kwargs=kw,
                         private=private, input_size=SIDE, device="cpu")
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (BATCH, SIDE, SIDE, 3))
             .astype(np.uint8),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
            for _ in range(2)]


def jax_draws(step, n):
    """make_train_step's draws for ``step`` at seed 0 (steps.py:113, :145,
    device_augment.py:58-84), as the port's (oy, ox, flip)."""
    kc, kf = jax.random.split(jax.random.fold_in(jax.random.key(1), step))
    offs = np.asarray(jax.random.randint(kc, (n, 2), 0, 2 * PAD + 1))
    flips = np.asarray(jax.random.bernoulli(kf, 0.5, (n,)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
                 for a in (offs[:, 0], offs[:, 1], flips))


def _run_both(case):
    config, private, split, *norm = STEP_CASES[case]
    jmodel, v, pmodel = _pair(config, private, *norm)
    jstep = jax_train_step(jmodel, private, split_branches=split,
                           device_augment=make_device_augment(PAD))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(LR))
    pstep = make_train_step(pmodel, private, split_branches=split, pad=PAD,
                            draws=jax_draws, device="cpu")
    pstate = TrainState.create(pmodel, LR)
    metrics = []
    for batch in _batches():
        jstate, jm = jstep(jstate, {k: jnp.asarray(a)
                                    for k, a in batch.items()})
        pstate, pm = pstep(pstate, batch)
        metrics.append((jm, pm))
    return jmodel, jstate, pmodel, pstate, metrics


@pytest.fixture(scope="module")
def trained():
    """Each case's models after two steps, built once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run_both(case)
        return cache[case]

    return get


# Tolerances of the two-step comparison. Metrics and BN running statistics:
# rtol 1e-4 / atol 1e-5. Parameters: rtol 1e-4 / atol 2e-4, and momentum
# buffers (the summed gradients): 5e-2 of each tensor's norm. The gap is
# not summation order but ReLU mask flips: a pre-ReLU activation within
# about 1e-5 of zero lands on opposite sides in XLA and in ATen (one per
# forward or so at these sizes; found with flax's capture_intermediates),
# and the flipped element's gradient moves every gradient below it. The
# port's f32 gradients agree with its own f64 gradients to 1.4e-6 of each
# tensor's largest entry. Measured worst, over the four cases: parameters
# 9.5e-5 beyond rtol (scheme 0), momentum 1.8e-2 of the norm (scheme 0).
# SGD itself (decay before momentum, schedule, W10) is held exactly by
# test_sgd_matches_optax_including_unused_parameters.
PARAM_TOL = dict(rtol=1e-4, atol=2e-4)
MOMENTUM_NORM_TOL = 5e-2


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(trained, case):
    _, jstate, pmodel, pstate, metrics = trained(case)
    assert pstate.step == 2 and int(jstate.step) == 2
    for jm, pm in metrics:
        assert sorted(pm) == sorted(jm)
        assert float(pm["sign_acc"]) == float(jm["sign_acc"])
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    params = dict(pmodel.named_parameters())
    want_params = jax_state_dict({"params": jstate.params})
    assert sorted(want_params) == sorted(params)
    for name, want in want_params.items():
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   err_msg=name, **PARAM_TOL)
    buffers = dict(pmodel.named_buffers())
    stats = jax_state_dict({"batch_stats": jstate.batch_stats})
    assert sorted(stats) == sorted(k for k in buffers
                                   if k.endswith(("_mean", "_var")))
    for name, want in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    trace = jax_state_dict({"params": jstate.opt_state[1].trace})
    for name, want in trace.items():
        got = pstate.optimizer.state[params[name]]["momentum_buffer"].numpy()
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= MOMENTUM_NORM_TOL, (name, err)


# ------------------------------------------- eval after training (§ repair)

def test_eval_entry_points_after_a_train_step(trained):
    """A train step leaves the model in train mode; the dual eval step and
    signature detection still run with the running statistics (JAX's
    train=False) and change none of them."""
    jmodel, jstate, pmodel, _, _ = trained("split_private")
    assert pmodel.training
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(size=(4, SIDE, SIDE, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 4).astype(np.int32)}
    before = {k: b.clone() for k, b in pmodel.named_buffers()}

    got = make_dual_eval_step(pmodel, device="cpu")(batch)
    want = jax_dual_eval_step(jmodel)(jstate, {k: jnp.asarray(a)
                                               for k, a in batch.items()})
    for k in want:
        if k.startswith("correct"):
            assert int(got[k]) == int(want[k]), k
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-3, atol=1e-3, err_msg=k)
    rates = make_signature_fn(pmodel, (1, SIDE, SIDE, 3), True,
                              device="cpu")()
    jrates = jax_test_signature(jmodel, jstate, (1, SIDE, SIDE, 3), True)
    assert rates == jrates

    for k, b in pmodel.named_buffers():
        assert torch.equal(b, before[k]), k
    assert pmodel.training and all(m.training for m in pmodel.modules())
    # and the eval logits are JAX's train=False logits
    x = batch["image"]
    with torch.inference_mode():
        pmodel.eval()
        logits = pmodel(nchw(x), ind=1).logits
        pmodel.train()
    jlogits = jmodel.apply(jstate.model_variables(), jnp.asarray(x), ind=1,
                           train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGITS_TOL)


# ------------------------------------------------------------ port only

def test_split_step_equals_two_full_forwards():
    _, _, split_model = _pair("resnet9_passport.json", True)
    full_model = build_model("resnet9", 10, device="cpu", input_size=SIDE,
                             private=True,
                             passport_kwargs=split_model.passport_kwargs)
    full_model.load_state_dict(split_model.state_dict())
    runs = []
    for model, split in ((split_model, True), (full_model, False)):
        step = make_train_step(model, True, split_branches=split, pad=PAD,
                               device="cpu")
        state = TrainState.create(model, LR)
        for batch in _batches(1):
            state, metrics = step(state, batch)
        runs.append((model, metrics))
    (a, ma), (b, mb) = runs
    for k in ma:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # tests/test_train.py:207's tolerance: the prefix's gradient sums the
    # two branches in another order
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_draws_depend_on_seed_and_step_alone():
    cpu = torch.device("cpu")
    a = seeded_draws(0, PAD, cpu)
    again = seeded_draws(0, PAD, cpu)
    torch.manual_seed(123)  # the global generator plays no part
    for x, y in zip(a(3, 64), again(3, 64)):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(a(3, 64), a(4, 64)))
    other = seeded_draws(1, PAD, cpu)
    assert any(not torch.equal(x, y) for x, y in zip(a(3, 64), other(3, 64)))


def test_v2_training_embeds_the_signature():
    """tests/test_train.py:75-96 for the port: 40 steps at lr 0.05 on a toy
    batch, then every passport layer's signature reads back exactly."""
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")),
        "bn", "shuffle", 0.1)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        input_size=SIDE, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(BATCH, SIDE, SIDE, 3))
             .astype(np.float32),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
    state = TrainState.create(model, 0.05)
    step = make_train_step(model, True, device="cpu")
    state, first = step(state, batch)
    for _ in range(39):
        state, metrics = step(state, batch)
    assert float(metrics["sign_acc"]) == 1.0
    assert float(metrics["loss"]) < float(first["loss"])
    rates = make_signature_fn(model, (1, SIDE, SIDE, 3), True,
                              device="cpu")()
    assert len(rates) == 3 and all(r == 1.0 for r in rates.values()), rates
    assert not any(isinstance(m, BatchNorm) and not m.training
                   for m in model.modules())
