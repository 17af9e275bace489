"""The port's attack suite against the JAX package's on equal weights.

A V2 ResNet9 (passport_configs/resnet9_passport.json: the three layer4
blocks) at 16x16 is initialised by flax, its BN statistics redrawn with
numpy, and loaded into the port (``resnet_pair``); every attack runs on both
sides over the same two batches of four images. Where the two packages draw
differently (W7), the JAX draws are injected into the port: the ambiguity
attack's 0.001-noise, the forge attack's U(-1, 1) passports, and the
pretrained model from which attack 1 derives its fake passports. NumPy draws
(sign flips, signature flips, forge targets, candidate sampling) are the
same on both sides by construction.

Tolerances: detection rates sign for sign; accuracy within one image of
eight (measured: equal); metrics and updates of parameters or passports
were asked to hold at rtol 1e-3 and 5 % of the update's norm (the logits'
LOGITS_TOL of test_torch_port_model.py; chip_smoke.py's card-vs-CPU update
bound, since a pre-ReLU value within float32 noise of zero can land on
opposite sides in XLA and ATen and move whole gradients), and are tightened
to ten times their measured worst below.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepipr_tpu.attacks import ambiguity as jax_ambiguity
from deepipr_tpu.attacks import common as jax_common
from deepipr_tpu.attacks import fake_passport as jax_fake
from deepipr_tpu.attacks import flip as jax_flip
from deepipr_tpu.attacks import forge as jax_forge
from deepipr_tpu.attacks import pruning as jax_pruning
from deepipr_tpu.attacks import reverse as jax_reverse
from deepipr_tpu.interop import surgery as jax_surgery
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.passport.derive import gap_channel_mean
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
    mark_separate_stats,
)

from deepipr_tpu_torch.attacks import ambiguity, common, fake_passport, flip
from deepipr_tpu_torch.attacks import forge, pruning, reverse
from deepipr_tpu_torch.interop import surgery
from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.ops.passport_epilogue import (
    passport_epilogue_backward_reference,
    passport_epilogue_reference,
)
from deepipr_tpu_torch.serve import passports

from test_torch_port_model import CONFIGS, RNGS, numpy_variables

SIZE = 16
SHAPE = (1, SIZE, SIZE, 3)
BATCH = 4
ONE_IMAGE = 100.0 / (2 * BATCH)  # one image of the eight, in percent
# metrics: measured worst 7.5e-7 relative (forge's MSE); losses,
# accuracies and detection rates mostly bit for bit
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
# each parameter's or passport's update, its difference from JAX's over its
# norm: measured worst 1.2e-5 (attack 2's trained BN scale)
UPDATE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files: the
    tier-1 run puts several pytest workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(separate_stats=False):
    """(JAX model, its TrainState, port model) on equal weights: a V2
    ResNet9 with the resnet9 passport config."""
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")),
        "bn", "random", 0.1)
    if separate_stats:
        mark_separate_stats(kw)
    jmodel = jax_resnet.ResNet9(num_classes=10, passport_kwargs=kw,
                                private=True)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((2, SIZE, SIZE, 3)),
                                    train=True), seed=4)
    pmodel = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                         input_size=SIZE, device="cpu")
    load_jax_variables(pmodel, v)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(0.01))
    return jmodel, state, pmodel


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def batches():
    """Two batches of four normalized NHWC images and their labels."""
    rng = np.random.default_rng(11)
    return [{"image": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(
                 np.float32),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
            for _ in range(2)]


PLKEYS = ["layer4.0.convbnrelu_1", "layer4.0.convbn_2", "layer4.0.shortcut"]
JAX_PLPATHS = [jax_common.plkey_to_module_path(k) for k in PLKEYS]
PLPATHS = [common.plkey_to_module_path(k) for k in PLKEYS]


def _port_tree(tree):
    """A JAX passport or signature tree as the port's buffer dict."""
    collection = "passport" if "key" in jax.tree_util.keystr(
        jax.tree_util.tree_flatten_with_path(tree)[0][0][0]) else "signature"
    return {k: torch.from_numpy(v) for k, v in
            jax_state_dict({collection: jax.device_get(tree)}).items()}


def _assert_rows(rows, jrows, exact=(), acc=(), close=()):
    assert len(rows) == len(jrows)
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow)
        for k in exact:
            assert row[k] == jrow[k], k
        for k in acc:
            assert abs(row[k] - jrow[k]) <= ONE_IMAGE + 1e-9, k
        for k in close:
            np.testing.assert_allclose(row[k], jrow[k], **METRIC_TOL,
                                       err_msg=k)


# ------------------------------------------------------------ common

def test_plkey_to_module_path_is_the_jax_path_with_dots():
    for key in PLKEYS + ["convbnrelu_1", "4"]:
        assert (common.plkey_to_module_path(key)
                == jax_common.plkey_to_module_path(key).replace("/", "."))


@pytest.mark.parametrize("to_unit_signs", [False, True])
@pytest.mark.parametrize("perc", [0.0, 0.3, 1.0])
def test_global_sign_flip_draws_match_jax(perc, to_unit_signs):
    rng = np.random.default_rng(2)
    vectors = [rng.normal(size=n).astype(np.float32) for n in (7, 64, 33)]
    got, sim = common.global_sign_flip(vectors, perc, 5, to_unit_signs)
    want, jsim = jax_common.global_sign_flip(vectors, perc, 5, to_unit_signs)
    assert sim == jsim
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("perc", [0.0, 0.1, 0.5])
def test_flip_signature_bits_draws_match_jax(pair, perc):
    _, state, pmodel = pair
    want = _port_tree(jax_ambiguity.flip_signature_bits(
        jax.device_get(state.signature), perc, 3))
    got = ambiguity.flip_signature_bits(ambiguity.signatures(pmodel), perc, 3)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


# ------------------------------------------------------------- pruning

@pytest.mark.parametrize("perc", [0, 50, 90])
def test_global_prune_masks_match_jax(pair, perc):
    _, state, pmodel = pair
    want = jax_state_dict({"params": jax.device_get(jax_pruning.global_prune(
        state.params, float(perc)))})
    got = pruning.global_prune(dict(pmodel.named_parameters()), float(perc))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_array_equal(g != 0, w != 0, err_msg=k)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_pruning_rows_match_jax(pair, batches):
    jmodel, state, pmodel = pair
    percents = (0, 50, 90)
    jrows = jax_pruning.pruning_attack(jmodel, state, batches, SHAPE, True,
                                       percents=percents)
    rows = pruning.pruning_attack(pmodel, batches, SHAPE, True,
                                  percents=percents)
    detect = [k for k in jrows[0] if k.startswith("detect_")]
    _assert_rows(rows, jrows, exact=["perc", *detect], acc=["acc"],
                 close=["loss"])


# ---------------------------------------------------------------- flip

def test_flip_rows_match_jax(pair, batches):
    jmodel, state, pmodel = pair
    percents = (0, 50, 100)
    jrows = jax_flip.flip_attack(jmodel, state, batches, SHAPE, True,
                                 JAX_PLPATHS, percents=percents, seed=1)
    rows = flip.flip_attack(pmodel, batches, SHAPE, True, PLPATHS,
                            percents=percents, seed=1)
    detect = [k for k in jrows[0] if k.startswith("detect_")]
    _assert_rows(rows, jrows, exact=["perc", "similarity", *detect],
                 acc=["acc"], close=["loss"])


# ------------------------------------------------------------ attack 1

def test_random_passport_attack_rows_match_jax(pair, batches):
    """Genuine row and two fake rows; the pretrained normal model that
    derives the fake passports is JAX's, loaded into the port."""
    jmodel, state, pmodel = pair
    jpre = jax_resnet.ResNet9(num_classes=10)
    pv = numpy_variables(jpre.init({"params": jax.random.key(2)},
                                   jnp.zeros((2, SIZE, SIZE, 3)), train=True),
                         seed=5)
    ppre = build_model("resnet9", 10, input_size=SIZE, device="cpu")
    load_jax_variables(ppre, pv)
    # 20 candidates a passport set (fake_passport.py:34), as attack 1's
    # first four validation batches give them
    cands = np.random.default_rng(12).normal(
        size=(24, SIZE, SIZE, 3)).astype(np.float32)
    jrows = jax_fake.random_passport_attack(
        jmodel, state, jpre, jax.tree.map(jnp.asarray, pv), cands, batches,
        reps=2, private=True, seed=0)
    rows = fake_passport.random_passport_attack(pmodel, ppre, cands, batches,
                                                reps=2, private=True, seed=0)
    # the fake passports are conv activations of the same images, equal up
    # to summation order; the detection rates of the derived scales agree
    # sign for sign (measured: equal)
    _assert_rows(rows, jrows, exact=["attack_rep", "valid_signacc"],
                 acc=["valid_acc"], close=["valid_loss"])


# ------------------------------------------------------------ attack 2

def test_reverse_attack_two_steps_match_jax(pair, batches):
    """The attacker's normal model (GroupNorm, as for a private scheme),
    half the scale signs flipped, then two affine-only steps: metrics, the
    frozen weights untouched, the trained affines' update and the similarity
    as JAX's."""
    jmodel, state, pmodel = pair
    jnormal = jax_resnet.ResNet9(num_classes=10, norm_type="gn")
    jstate, jsim = jax_reverse.build_attacked_normal_state(
        jmodel, state, jnormal, SHAPE, True, JAX_PLPATHS, 0.5, lr=0.01,
        seed=0)
    pnormal = build_model("resnet9", 10, norm_type="gn", input_size=SIZE,
                          device="cpu")
    pstate, sim = reverse.build_attacked_normal_state(
        pmodel, pnormal, SHAPE, True, PLPATHS, 0.5, lr=0.01, seed=0)
    assert sim == jsim
    start = {k: v.detach().clone() for k, v in pnormal.state_dict().items()}
    want0 = jax_state_dict({"params": jax.device_get(jstate.params)})
    for k, w in want0.items():
        np.testing.assert_allclose(start[k].numpy(), w, rtol=1e-3, atol=1e-5,
                                   err_msg=k)

    jstep = jax_reverse.make_affine_train_step(jnormal)
    step = reverse.make_affine_train_step(pnormal)
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pstate, m = step(pstate, batch)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       **METRIC_TOL, err_msg=k)
    want = jax_state_dict({"params": jax.device_get(jstate.params)})
    trained = {f"{p}.bn.{leaf}" for p in PLPATHS for leaf in ("weight",
                                                             "bias")}
    for k, w in want.items():
        got = pnormal.state_dict()[k]
        if k not in trained:
            assert torch.equal(got, start[k]), k
            continue
        update = w - want0[k]
        err = np.linalg.norm(got.numpy() - w) / np.linalg.norm(update)
        assert err <= UPDATE_TOL, (k, err)


# ------------------------------------------------------------ attack 3

def _jax_noise(orig_pp, seed):
    """The unit normal draws of JAX's ambiguity_attack (ambiguity.py:128-137),
    keyed by the port's buffer names."""
    leaves, treedef = jax.tree.flatten(orig_pp)
    rngs = jax.random.split(jax.random.key(seed), len(leaves))
    draws = jax.tree.unflatten(
        treedef, [np.asarray(jax.random.normal(r, np.shape(l)))
                  for l, r in zip(leaves, rngs)])
    return _port_tree(draws)


def test_ambiguity_attack_two_steps_match_jax(pair, batches):
    """Two steps of attack 3 with 10 % of the signature flipped and JAX's
    noise: the epoch's mean metrics at rtol 1e-3 and each fake passport's
    update within UPDATE_TOL of its norm. The coefficient of the maximize
    term defaults to JAX's 2.0 (W4)."""
    jmodel, state, pmodel = pair
    seed = 0
    jfake, jhist = jax_ambiguity.ambiguity_attack(
        jmodel, state, batches, batches, epochs=1, private=True,
        flipperc=0.1, lr=0.01, seed=seed)
    noise = _jax_noise(jax.device_get(state.passport), seed)
    fake, hist = ambiguity.ambiguity_attack(
        pmodel, batches, batches, epochs=1, private=True, flipperc=0.1,
        lr=0.01, seed=seed, noise=noise)
    assert ambiguity.MAXIMIZE_COEF == 2.0
    (row,), (jrow,) = hist, jhist
    assert set(row) == set(jrow)
    for k, v in jrow.items():
        np.testing.assert_allclose(row[k], v, **METRIC_TOL, err_msg=k)
    want = _port_tree(jfake)
    orig = passports(pmodel)
    for k, w in want.items():
        start = orig[k] + 0.001 * noise[k]
        err = ((fake[k] - w).norm() / (w - start).norm()).item()
        assert err <= UPDATE_TOL, (k, err)


def test_ambiguity_scan_epoch_runs_the_input_stage(pair):
    """--epoch-scan: the set resident on the device, each batch through
    K1's plain version (on the CPU); steps = images // batch, metrics
    finite, every fake passport moved."""
    from deepipr_tpu_torch.data.datasets import DataLoader, synthetic_dataset
    from deepipr_tpu_torch.ops.fused_augment import fused_augment

    _, _, pmodel = pair
    x, y, _, _ = synthetic_dataset(num_train=12, num_test=0, size=SIZE)
    loader = DataLoader(x, y, BATCH, shuffle=True, train_augment=True,
                        drop_last=True)
    before = fused_augment.launches
    fake, (row,) = ambiguity.ambiguity_attack(
        pmodel, loader, None, epochs=1, private=True, scan_epochs=True)
    assert fused_augment.launches == before  # the plain version on the CPU
    assert all(np.isfinite(v) for v in row.values())
    for k, v in passports(pmodel).items():
        assert not torch.equal(fake[k], v)


# -------------------------------------------------------------- forge

def _jax_uniform(orig_pp, seed):
    """The U(-1, 1) draws of JAX's forge_attack (forge.py:124-130)."""
    leaves, treedef = jax.tree.flatten(orig_pp)
    rngs = jax.random.split(jax.random.key(seed), len(leaves))
    draws = jax.tree.unflatten(
        treedef, [np.asarray(jax.random.uniform(r, np.shape(l), jnp.float32,
                                                -1.0, 1.0))
                  for l, r in zip(leaves, rngs)])
    return _port_tree(draws)


def test_forge_targets_match_jax(pair):
    jmodel, state, pmodel = pair
    jt, jb = jax_forge.forge_targets(jmodel, state, SHAPE, 0.5, 3)
    t, b = forge.forge_targets(pmodel, SHAPE, 0.5, 3)
    assert list(t) == list(jt) and list(b) == list(jb)
    for path in jt:
        for k in ("scale", "bias"):
            np.testing.assert_array_equal(t[path][k].numpy(),
                                          np.asarray(jt[path][k]))
        np.testing.assert_array_equal(b[path].numpy(), np.asarray(jb[path]))


def test_forge_attack_two_steps_match_jax(pair):
    """Two Adam steps from JAX's U(-1, 1) passports: the logged MSE and sign
    accuracy, and each passport's update within UPDATE_TOL of its norm."""
    jmodel, state, pmodel = pair
    jpp, jb, jhist = jax_forge.forge_attack(
        jmodel, state, SHAPE, flipperc=0.5, steps=2, lr=0.05, seed=0,
        log_every=1)
    init = _jax_uniform(jax.device_get(state.passport), 1)
    pp, b, hist = forge.forge_attack(pmodel, SHAPE, flipperc=0.5, steps=2,
                                     lr=0.05, seed=0, log_every=1, init=init)
    assert len(hist) == len(jhist) == 2
    for row, jrow in zip(hist, jhist):
        assert row["step"] == jrow["step"]
        np.testing.assert_allclose(row["mse"], jrow["mse"], **METRIC_TOL)
        assert row["sign_acc"] == jrow["sign_acc"]
    want = _port_tree(jpp)
    for k, w in want.items():
        err = ((pp[k] - w).norm() / (w - init[k]).norm()).item()
        assert err <= UPDATE_TOL, (k, err)
    jacc = jax_forge.forged_signature_accuracy(jmodel, state, jpp, jb, SHAPE)
    assert forge.forged_signature_accuracy(pmodel, pp, b, SHAPE) == jacc


def test_refine_with_data_matches_jax(pair, batches):
    """One epoch (two steps) of the data-assisted escalation from the same
    forged passports: the epoch's mean metrics."""
    jmodel, state, pmodel = pair
    jb = jax_forge.forge_targets(jmodel, state, SHAPE, 0.25, 0)[1]
    pp0 = jax.device_get(state.passport)
    _, jhist = jax_forge.refine_with_data(jmodel, state, pp0, jb, batches,
                                          epochs=1)
    b = {p: torch.from_numpy(np.array(v)) for p, v in jb.items()}
    _, hist = forge.refine_with_data(pmodel, passports(pmodel), b, batches,
                                     epochs=1)
    (row,), (jrow,) = hist, jhist
    assert set(row) == set(jrow)
    for k, v in jrow.items():
        np.testing.assert_allclose(row[k], v, **METRIC_TOL, err_msg=k)


# ------------------------------------------------------------ surgery

@pytest.mark.parametrize("separate_stats", [False, True])
def test_passport_to_normal_matches_jax(separate_stats):
    """V2 -> a BN normal model: copied weights and statistics, the derived
    affines in the passport layers' norms, and with separate stats the
    private branch's statistics paired with them (surgery.py:64-75)."""
    jmodel, state, pmodel = _pair(separate_stats)
    if separate_stats:  # the private statistics differ from the public
        with torch.no_grad():
            for name, buf in pmodel.named_buffers():
                if ".bn_private." in name:
                    buf.add_(0.25)
        v = state.model_variables()
        stats = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.25 if "bn_private" in jax.tree_util.keystr(p)
            else x, jax.device_get(v["batch_stats"]))
        state = state.replace(batch_stats=stats)
    jnormal = jax_resnet.ResNet9(num_classes=10)
    nv = numpy_variables(jnormal.init({"params": jax.random.key(0)},
                                      jnp.zeros((2, SIZE, SIZE, 3)),
                                      train=True), seed=6)
    jaff = jax_common.derived_affines(jmodel, state.model_variables(), SHAPE,
                                      True)
    jp, js = jax_surgery.passport_to_normal(
        state.params, state.batch_stats, jaff, nv["params"],
        nv["batch_stats"], JAX_PLPATHS)
    pnormal = build_model("resnet9", 10, input_size=SIZE, device="cpu")
    load_jax_variables(pnormal, nv)
    aff = common.derived_affines(pmodel, SHAPE, True)
    got = surgery.passport_to_normal(pmodel.state_dict(), aff,
                                     pnormal.state_dict(), PLPATHS)
    want = jax_state_dict({"params": jax.device_get(jp),
                           "batch_stats": jax.device_get(js)})
    assert set(got) == set(want)
    derived = {f"{p}.bn.{k}" for p in PLPATHS for k in ("weight", "bias")}
    for k, w in want.items():
        # derived scales: summation order (test_torch_port_model's SCALE_TOL)
        tol = dict(rtol=1e-3, atol=1e-5) if k in derived else dict(rtol=0,
                                                                   atol=0)
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)
    pnormal.load_state_dict(got)  # a complete state dict of the model


def test_normal_to_passport_and_copy_matching(pair):
    _, _, pmodel = pair
    normal = build_model("resnet9", 10, input_size=SIZE, seed=3, device="cpu")
    nsd = normal.state_dict()
    got = surgery.normal_to_passport(nsd, pmodel.state_dict(), PLPATHS)
    for p in PLPATHS:
        assert torch.equal(got[f"{p}.scale"], nsd[f"{p}.bn.weight"])
        assert torch.equal(got[f"{p}.key"], pmodel.state_dict()[f"{p}.key"])
    assert torch.equal(got["linear.weight"], nsd["linear.weight"])
    other = build_model("resnet9", 100, input_size=SIZE, device="cpu")
    kept = surgery.normal_to_normal(nsd, other.state_dict())
    assert kept["linear.weight"].shape == (100, 512)
    assert torch.equal(kept["convbnrelu_1.conv.weight"],
                       nsd["convbnrelu_1.conv.weight"])


# ------------------------------------------------------- K2's gradient

def _jax_xla_epilogue(y, key_out, skey_out, mean, var, relu):
    """The JAX package's eval path of a BN passport block after the
    convolution (layers.py:178-186): GAP, flax BatchNorm with running
    statistics, affine, ReLU; NHWC."""
    scale = gap_channel_mean(skey_out)
    bias = gap_channel_mean(key_out)
    bn = nn.BatchNorm(use_running_average=True, use_scale=False,
                      use_bias=False, epsilon=1e-5)
    yn = bn.apply({"batch_stats": {"mean": mean, "var": var}}, y)
    out = scale.reshape(1, 1, 1, -1) * yn + bias.reshape(1, 1, 1, -1)
    return (nn.relu(out) if relu else out), scale, bias


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(4, 16, 4, 4), (3, 40, 5, 3)])
def test_epilogue_backward_reference_matches_jax_vjp(shape, relu):
    n, c, h, w = shape
    rng = np.random.default_rng(9)
    y, key_out, skey_out = (rng.normal(size=s).astype(np.float32)
                            for s in (shape, (1, c, h, w), (1, c, h, w)))
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    gs, gb = rng.normal(size=(2, c)).astype(np.float32)

    def nhwc(a):
        return jnp.asarray(a.transpose(0, 2, 3, 1))

    (jout, _, _), vjp = jax.vjp(
        lambda a, k, s: _jax_xla_epilogue(a, k, s, jnp.asarray(mean),
                                          jnp.asarray(var), relu),
        nhwc(y), nhwc(key_out), nhwc(skey_out))
    want = vjp((nhwc(g), jnp.asarray(gs), jnp.asarray(gb)))

    t = [torch.from_numpy(a) for a in (y, key_out, skey_out, mean, var)]
    out, scale, _ = passport_epilogue_reference(*t, relu=relu)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jout), rtol=1e-5, atol=1e-5)
    got = passport_epilogue_backward_reference(
        torch.from_numpy(g), t[0], out, scale, t[3], t[4],
        torch.from_numpy(gs), torch.from_numpy(gb), relu=relu)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(b), rtol=1e-5, atol=1e-5)

    # and against torch autograd of the plain forward
    leaves = [x.clone().requires_grad_(True) for x in t[:3]]
    o, s, b = passport_epilogue_reference(*leaves, t[3], t[4], relu=relu)
    auto = torch.autograd.grad(
        (o * torch.from_numpy(g)).sum() + (s * torch.from_numpy(gs)).sum()
        + (b * torch.from_numpy(gb)).sum(), leaves)
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
