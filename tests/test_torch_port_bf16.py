"""bf16 mixed precision of the port against the JAX package's, on the CPU.

The JAX package trains in bf16 as ``bench.py`` and ``--bf16`` run it: a
model-level ``dtype=jnp.bfloat16`` with f32 weights, f32 BN statistics and
f32 passport derivation, the input stage writing bf16. The port does the
same with ``dtype=torch.bfloat16`` (no autocast). These tests hold K1's and
K2's bf16 plain versions, the bf16 blocks, a bf16 ResNet9 private model and
a bf16 split V2 train step to JAX on the same weights and draws (W7), and
repeat tests/test_bf16.py's twin check on the port. JAX runs as its own
tests run it (XLA on the CPU, the Pallas input stage in interpret mode).
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
from deepipr_tpu.models import layers as jax_layers
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.ops.conv import Conv2D as JaxConv2D
from deepipr_tpu.ops.pallas_augment import make_pallas_augment
from deepipr_tpu.passport.derive import (
    fused_conv_passport_outputs as jax_fused_conv_passport_outputs,
)
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.train.steps import (
    collect_aux,
    make_train_step as jax_train_step,
)
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.data.device_augment import normalize_device, scaled_stats
from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models import layers
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.fused_augment import fused_augment
from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_signature_fn, make_train_step

from test_torch_port_augment import jax_draws, port_draws
from test_torch_port_model import CONFIGS, RNGS, nchw, numpy_variables, to_nhwc
from test_torch_port_train import jax_draws as jax_step_draws

BF16 = torch.bfloat16
PAD, BATCH, SIDE, LR = 2, 16, 16, 0.01

# Blocks in bf16: measured equal to JAX bit for bit at eval and in train
# mode (the bf16 conv, the f32 normalize rounded once, the bf16 affine);
# held at 1 bf16 ulp, the bound the K2 form is held to on the card. (A
# derived scale within an f32 ulp of a bf16 rounding midpoint could round
# the other way on either side and, where scale * yn and bias cancel, move
# an output by more than that; none of these inputs has one.)
BLOCK_ULPS = 1
# bf16 scale/bias from f32 passport outputs: measured worst 7.5e-9 (the GAP
# sums in another order); TestIntegratedEpilogue's scale/bias tolerance.
AFFINE_TOL = dict(rtol=1e-5, atol=1e-6)
# Running statistics after one bf16 train-mode forward: f32 statistics of
# equal bf16 activations, summed in other orders; measured worst 1.2e-7
# relative.
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
# ResNet9 private bf16 logits (largest 4.5): measured worst 8.4e-3
# absolute (a bf16 ulp of a hidden unit is 2^-8 of it, and a few flip where
# XLA and ATen sum a convolution in other orders); held at about 2x.
LOGITS_TOL = dict(rtol=1e-2, atol=2e-2)
# Derived scale/bias of the bf16 ResNet9 (f32 GAPs of bf16 passport
# convolutions): measured worst 1.5e-5 absolute; signs exactly.
SCALE_TOL = dict(rtol=1e-3, atol=3e-5)
# The bf16 split V2 train step, two steps, against JAX's. Metrics: measured
# within 1.0e-3 relative. Parameters are held norm-wise, each parameter's
# update (after - before) and the whole update vector: bf16 backward passes
# are ill-conditioned elementwise (a bf16 rounding or ReLU-kink flip moves
# whole gradients). Measured worst 0.287 of one parameter's update norm (an
# early BN bias) and 0.057 of the whole update, where the port moves 0.251
# of a parameter's update under a 1e-6 perturbation of its own weights and
# its bf16 step lies 0.260 from its f32 step (JAX's: 0.281), so the port is
# as close to JAX as bf16 lets either be to itself. BN running statistics
# after the two steps: measured worst 4.1e-3 absolute.
STEP_METRIC_TOL = dict(rtol=3e-3, atol=1e-3)
UPDATE_NORM_TOL = 0.6
WHOLE_UPDATE_TOL = 0.12
STEP_STATS_TOL = dict(rtol=1e-2, atol=8e-3)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test: the tier-1 run puts several pytest
    workers on the same cores, where bf16 CPU kernels spinning on eight
    threads each slowed one test from seconds to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 units in the last place between two
    arrays of bf16 values (given as f32), sign bit included."""
    a = torch.as_tensor(np.asarray(a, np.float32)).to(BF16)
    b = torch.as_tensor(np.asarray(b, np.float32)).to(BF16)

    def ordered(t):  # bf16 bit patterns as a monotone integer line
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return int((ordered(a) - ordered(b)).abs().max())


# ------------------------------------------------------------- K1 in bf16

def _all_values_set(side):
    """64 images of ``side``x``side``x3 that between them hold every uint8
    value in every channel, in a seeded order."""
    rng = np.random.default_rng(11)
    flat = np.tile(np.arange(256, dtype=np.uint8), -(-64 * side * side * 3
                                                      // 256))
    return rng.permutation(flat[:64 * side * side * 3]).reshape(
        64, side, side, 3)


@pytest.mark.parametrize("pad,side", [(4, 32), (2, 16)])
@pytest.mark.parametrize("reference", ["pallas", "slice", "onehot"])
def test_k1_plain_version_bf16_is_bit_identical_to_jax(pad, side, reference):
    ds = _all_values_set(side)
    idx = np.random.default_rng(side).permutation(64)[:16].astype(np.int32)
    key = jax.random.key(5)
    if reference == "pallas":
        pal = make_pallas_augment(pad, height=side, width=side, block=8,
                                  out_dtype=jnp.bfloat16, interpret=True)
        want = pal(key, jnp.asarray(ds), jnp.asarray(idx))
    else:
        want = jax_device_augment(pad, crop_impl=reference,
                                  out_dtype=jnp.bfloat16)(
            key, jnp.asarray(ds[idx]))
    assert want.dtype == jnp.bfloat16
    offs, flips = jax_draws(key, 16, pad)
    m, s = scaled_stats()
    got = fused_augment(torch.from_numpy(ds), torch.from_numpy(idx),
                        *port_draws(offs, flips), m, s, pad, BF16)
    assert got.dtype == BF16 and got.shape == (16, 3, side, side)
    np.testing.assert_array_equal(
        to_nhwc(got.view(torch.int16)),
        np.asarray(want).view(np.int16))


def test_normalize_device_bf16_is_bit_identical_to_jax():
    ds = _all_values_set(16)
    want = jax_normalize_device(jnp.asarray(ds), jnp.bfloat16)
    got = normalize_device(torch.from_numpy(ds), BF16)
    np.testing.assert_array_equal(to_nhwc(got.view(torch.int16)),
                                  np.asarray(want).view(np.int16))


def test_k1_rejects_other_dtypes():
    ds = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    idx = torch.arange(2, dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_augment(ds, idx, z, z, z, *scaled_stats(), 1, torch.float16)


# ------------------------------------------------------------- K2 in bf16

def _private_block(seed=0):
    kw = {"norm_type": "bn", "alpha": 0.1, "b_spec": 7}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 4, 4, 64)).astype(np.float32)
    jblock = jax_layers.PassportPrivateBlock(features=256,
                                             dtype=jnp.bfloat16, **kw)
    v = numpy_variables(jblock.init(RNGS, jnp.asarray(x), train=True),
                        seed=seed + 1)
    pblock = layers.PassportPrivateBlock(64, 256, input_hw=(4, 4),
                                         dtype=BF16, **kw).eval()
    load_jax_variables(pblock, v)
    return jblock, v, pblock, x


@pytest.mark.parametrize("relu", [True, False])
def test_k2_plain_version_bf16_matches_the_jax_block(relu):
    """K2's plain version on JAX's own bf16 conv outputs against the JAX
    XLA path of the bf16 PassportPrivateBlock at eval."""
    jblock, v, _, x = _private_block()
    jblock = jblock.clone(relu=relu)
    jy, upd = jblock.apply(v, jnp.asarray(x), ind=1, train=False,
                           mutable=["passport_aux"])
    conv = JaxConv2D(256, 3, 1, 1, dtype=jnp.bfloat16)
    y, key_out, skey_out = jax_fused_conv_passport_outputs(
        jnp.asarray(x), jnp.asarray(v["passport"]["key"]),
        jnp.asarray(v["passport"]["skey"]),
        lambda z: conv.apply({"params": v["params"]["conv"]}, z))
    assert y.dtype == jnp.bfloat16 and key_out.dtype == jnp.float32
    stats = v["batch_stats"]["bn"]
    out, scale, bias = passport_epilogue(
        nchw(np.asarray(y, np.float32)).to(BF16),
        nchw(np.asarray(key_out)), nchw(np.asarray(skey_out)),
        torch.from_numpy(stats["mean"]), torch.from_numpy(stats["var"]),
        relu=relu)
    assert out.dtype == BF16 and scale.dtype == torch.float32
    assert bf16_ulps(to_nhwc(out.float()), jy) <= BLOCK_ULPS
    jaux = collect_aux(upd)[0]
    np.testing.assert_allclose(scale.numpy(), np.asarray(jaux["scale"]),
                               **AFFINE_TOL)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jaux["bias"]),
                               **AFFINE_TOL)


def test_k2_rejects_other_dtypes():
    y = torch.zeros((2, 8, 4, 4), dtype=torch.float16)
    k = torch.zeros((1, 8, 4, 4))
    with pytest.raises(TypeError):
        passport_epilogue(y, k, k, torch.zeros(8), torch.ones(8))
    with pytest.raises(TypeError):  # the passport outputs stay f32 (W5)
        passport_epilogue(y.to(BF16), k.to(BF16), k, torch.zeros(8),
                          torch.ones(8))


# ------------------------------------------------------------ bf16 blocks

BLOCK_CASES = {
    "conv": ("conv", {}),
    "v1": ("v1", {}),
    "v1_learnable": ("v1_learnable", {}),
    "private_ind0": ("private", {"ind": 0}),
    "private_ind1": ("private", {"ind": 1}),
}


def _bf16_block_pair(kind):
    kw = {"norm_type": "bn", "alpha": 0.1, "b_spec": 7}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4, 4, 64)).astype(np.float32)
    if kind == "conv":
        jblock = jax_layers.ConvBlock(features=256, dtype=jnp.bfloat16)
        pblock = layers.ConvBlock(64, 256, dtype=BF16)
    elif kind == "private":
        jblock = jax_layers.PassportPrivateBlock(features=256,
                                                 dtype=jnp.bfloat16, **kw)
        pblock = layers.PassportPrivateBlock(64, 256, input_hw=(4, 4),
                                             dtype=BF16, **kw)
    else:
        learn = kind == "v1_learnable"
        jblock = jax_layers.PassportBlock(features=256, dtype=jnp.bfloat16,
                                          learnable_affine=learn, **kw)
        pblock = layers.PassportBlock(64, 256, input_hw=(4, 4), dtype=BF16,
                                      learnable_affine=learn, **kw)
    v = numpy_variables(jblock.init(RNGS, jnp.asarray(x), train=True), seed=1)
    load_jax_variables(pblock, v)
    return jblock, v, pblock, x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_bf16_block_matches_jax(case, train):
    kind, call = BLOCK_CASES[case]
    jblock, v, pblock, x = _bf16_block_pair(kind)
    jy, upd = jblock.apply(v, jnp.asarray(x), train=train,
                           mutable=["batch_stats", "passport_aux"], **call)
    pblock.train(train)
    with torch.no_grad():
        y, aux = pblock(nchw(x), **call)
    assert jy.dtype == jnp.bfloat16 and y.dtype == BF16
    assert bf16_ulps(to_nhwc(y.float()), jy) <= BLOCK_ULPS
    jaux = collect_aux(upd)
    assert (aux is None) == (not jaux)
    if aux is not None:
        for k in ("scale", "bias"):
            assert aux[k].dtype == torch.float32
            np.testing.assert_allclose(aux[k].numpy(),
                                       np.asarray(jaux[0][k]), **AFFINE_TOL)
    if train:
        want = jax_state_dict({"batch_stats": upd["batch_stats"]})
        got = {k: t.numpy() for k, t in pblock.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **STATS_TOL)


# ------------------------------------------------------- a bf16 ResNet9

@pytest.fixture(scope="module")
def resnet9_bf16():
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")), "bn",
        "random", 0.1)
    jmodel = jax_resnet.ResNet9(num_classes=10, passport_kwargs=kw,
                                private=True, dtype=jnp.bfloat16)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((2, SIDE, SIDE, 3)),
                                    train=True), seed=0)
    pmodel = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                         input_size=SIDE, dtype=BF16, device="cpu")
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


@pytest.mark.parametrize("ind", [0, 1])
def test_bf16_resnet9_logits_match_jax(resnet9_bf16, ind):
    jmodel, v, pmodel = resnet9_bf16
    x = np.random.default_rng(3).normal(size=(4, SIDE, SIDE, 3)) \
        .astype(np.float32)
    jl = jmodel.apply(v, jnp.asarray(x), ind=ind, train=False)
    with torch.inference_mode():
        pl = pmodel(nchw(x), ind=ind).logits
    assert pl.dtype == torch.float32 and jl.dtype == jnp.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS_TOL)


def test_bf16_resnet9_derived_scales_match_jax_sign_for_sign(resnet9_bf16):
    jmodel, v, pmodel = resnet9_bf16
    jaff = jax_derived_affines(jmodel, v, (1, SIDE, SIDE, 3), private=True)
    paff = derived_affines(pmodel, (1, SIDE, SIDE, 3), private=True)
    assert sorted(paff) == sorted(jaff) and len(jaff) == 3
    for path in jaff:
        for k in ("scale", "bias"):
            want = np.asarray(jaff[path][k])
            got = paff[path][k].numpy()
            np.testing.assert_allclose(got, want, err_msg=path, **SCALE_TOL)
        np.testing.assert_array_equal(np.sign(paff[path]["scale"].numpy()),
                                      np.sign(np.asarray(
                                          jaff[path]["scale"])))


# ------------------------------------------------ a bf16 split V2 step

def test_bf16_split_v2_train_step_matches_jax(resnet9_bf16):
    """Two bf16 split V2 steps on K1's bf16 output (the port's plain
    version, JAX's XLA stage) from the same weights and draws."""
    jmodel, v, _ = resnet9_bf16
    pmodel = build_model("resnet9", 10, passport_kwargs=jmodel.passport_kwargs,
                         private=True, input_size=SIDE, dtype=BF16,
                         device="cpu")
    load_jax_variables(pmodel, v)
    start = {k: p.detach().clone() for k, p in pmodel.named_parameters()}
    jstep = jax_train_step(jmodel, True, device_augment=jax_device_augment(
        PAD, out_dtype=jnp.bfloat16))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(LR))
    pstep = make_train_step(pmodel, True, pad=PAD, draws=jax_step_draws,
                            out_dtype=BF16, device="cpu")
    pstate = TrainState.create(pmodel, LR)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {"image": rng.integers(0, 256, (BATCH, SIDE, SIDE, 3))
                 .astype(np.uint8),
                 "label": rng.integers(0, 10, BATCH).astype(np.int32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(a)
                                    for k, a in batch.items()})
        pstate, pm = pstep(pstate, batch)
        assert sorted(pm) == sorted(jm)
        assert all(t.dtype == torch.float32 for t in pm.values())
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                       **STEP_METRIC_TOL)
    params = dict(pmodel.named_parameters())
    want = jax_state_dict({"params": jstate.params})
    assert sorted(want) == sorted(params)
    diff, norm = [], []
    for name, w in want.items():
        assert params[name].dtype == torch.float32  # f32 master weights
        moved = w - start[name].numpy()
        got = params[name].detach().numpy() - start[name].numpy()
        err = np.linalg.norm(got - moved) / max(np.linalg.norm(moved), 1e-30)
        assert err <= UPDATE_NORM_TOL, (name, err)
        diff.append(got - moved)
        norm.append(moved)
    whole = (np.linalg.norm(np.concatenate([d.ravel() for d in diff]))
             / np.linalg.norm(np.concatenate([m.ravel() for m in norm])))
    assert whole <= WHOLE_UPDATE_TOL, whole
    stats = jax_state_dict({"batch_stats": jstate.batch_stats})
    buffers = dict(pmodel.named_buffers())
    for name, w in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), w, err_msg=name,
                                   **STEP_STATS_TOL)


# -------------------------------- tests/test_bf16.py's twin, on the port

def _train_twin(dtype, steps=40):
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")), "bn",
        "shuffle", 0.1)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        input_size=SIDE, dtype=dtype, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(BATCH, SIDE, SIDE, 3))
             .astype(np.float32),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
    state = TrainState.create(model, 0.05)
    step = make_train_step(model, True, device="cpu")
    for _ in range(steps):
        state, metrics = step(state, batch)
    return model, metrics


def test_bf16_signs_agree_with_f32_twin_and_the_signature():
    """Same weights, data and steps, differing only in compute dtype: both
    decode the whole signature and their derived scales agree sign for
    sign with each other and with ``b``."""
    (mb, metrics_b), (mf, _) = _train_twin(BF16), _train_twin(None)
    assert float(metrics_b["sign_acc"]) == 1.0
    rates = make_signature_fn(mb, (1, SIDE, SIDE, 3), True, device="cpu")()
    assert len(rates) == 3 and all(r == 1.0 for r in rates.values()), rates
    ab = derived_affines(mb, (1, SIDE, SIDE, 3), private=True)
    af = derived_affines(mf, (1, SIDE, SIDE, 3), private=True)
    assert sorted(ab) == sorted(af)
    for path in ab:
        sb = torch.sign(ab[path]["scale"])
        assert torch.equal(sb, torch.sign(af[path]["scale"])), path
        assert torch.equal(sb, torch.sign(ab[path]["b"])), path


def test_bf16_model_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("resnet9", 10, input_size=SIDE, dtype=BF16)
    with pytest.raises(ValueError):
        build_model("resnet9", 10, input_size=SIDE, dtype=torch.float16,
                    device="cpu")
