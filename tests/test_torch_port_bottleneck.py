"""The port's Bottleneck and ResNet34/50 against the JAX package, on the CPU.

Blocks and the small net are initialised by flax; the full-width models
take the port's initial weights exported as the JAX tree, checked against
the paths and shapes of JAX's init (flax's jitted init of a full-width
model costs seconds). BN statistics are redrawn with numpy (and, for the
interop cases, the learned affines moved off their initial values), and
the variable tree is loaded into the port with ``load_jax_variables``. JAX runs at 'highest' matmul precision
(tests/conftest.py) with its XLA epilogue; the port through its kernels'
plain versions, on one intra-op thread.

- Bottleneck blocks at narrow widths (in 32 or 16, planes 8, 8x8), eval and
  train mode: normal, V1, private at ind 0 and 1, separate statistics, an
  identity and a projection shortcut at stride 1, stride 2, and a config
  without the ``shortcut`` key. convbn_3 and shortcut take K2 without its
  ReLU (``resnet.py:156-168`` of the JAX package).
- ResNet50Private at full width (passport_configs/resnet50_passport.json)
  at (2,32,32,3): logits of both branches, K2's 10 calls (4 without the
  ReLU), the 10 derived scales sign for sign, the detection rows in the
  order of JAX's ``plkeys`` and verify_ownership's, the fork and its 14
  prefix units; fold, ``.pth`` export (and JAX's file imported) and
  ``export_jax_variables``.
- ResNet-34, normal and with a layer4 config written to a temporary file;
  the registry and the package's exports as JAX's.
- A small ResNet(Bottleneck, (1, 1, 1, 1)) with layer4 flagged: key setup
  (shuffle), two split V2 train steps in f32 and in bf16, remat="full"
  against "none", one attack-3 step (K2's gradient without the ReLU mask
  at convbn_3 and shortcut), passport -> normal surgery.
- Torchvision ResNet-34/50 from hand-built state dicts at 64 px; ResNet-101
  and -152 built with JAX's variable shapes; the CLIs with --arch resnet50
  (scheme 0, V2 on the device-resident epoch, --eval).

Tolerances are the existing files': LOGITS_TOL, BLOCK_TOL and SCALE_TOL
(test_torch_port_model.py), the train step's (test_torch_port_train.py),
the bf16 step's (test_torch_port_bf16.py), the attacks' METRIC_TOL and
UPDATE_TOL (test_torch_port_attacks.py) and FOLD_TOL
(test_torch_port_interop.py).
"""

import csv
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepipr_tpu.attacks import ambiguity as jax_ambiguity
from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.attacks.common import (
    plkey_to_module_path as jax_plkey_to_module_path,
)
from deepipr_tpu.data.device_augment import make_device_augment
from deepipr_tpu.interop.fold import fold_for_inference as jax_fold
from deepipr_tpu.interop.torch_export import (
    export_torch_state_dict as jax_export,
)
from deepipr_tpu.interop.torchvision_import import (
    import_torchvision as jax_import_torchvision,
)
import deepipr_tpu.models as jax_models
from deepipr_tpu.attacks.common import (
    detect_signature_from_affines as jax_detect,
)
from deepipr_tpu.interop import surgery as jax_surgery
from deepipr_tpu.models import registry as jax_registry
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.models.branching import branch_point as jax_branch_point
from deepipr_tpu.train import keys as jax_keys
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.train.steps import (
    collect_aux_with_paths,
    make_train_step as jax_train_step,
)
from deepipr_tpu.utils.config import (
    construct_passport_kwargs as jax_construct_passport_kwargs,
    load_passport_config,
)

import deepipr_tpu_torch.models as port_models
import deepipr_tpu_torch.models.layers as port_layers
from deepipr_tpu_torch.attacks import ambiguity
from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.interop import surgery, torch_export, torch_import
from deepipr_tpu_torch.interop import torchvision_import
from deepipr_tpu_torch.interop.jax_params import (
    export_jax_variables,
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.branching import branch_point
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.models.resnet import Bottleneck, ResNet
from deepipr_tpu_torch.ops.passport_epilogue import passport_epilogue
from deepipr_tpu_torch.serve import Predictor, passports, verify_ownership
from deepipr_tpu_torch.train import keys
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_signature_fn, make_train_step
from deepipr_tpu_torch.utils.config import construct_passport_kwargs

from test_torch_port_attacks import METRIC_TOL, UPDATE_TOL, _jax_noise, \
    _port_tree
from test_torch_port_bf16 import STEP_STATS_TOL, UPDATE_NORM_TOL
from test_torch_port_interop import FOLD_TOL, _jax_logits, _moved_affines
from test_torch_port_model import (
    BLOCK_TOL,
    CONFIGS,
    LOGITS_TOL,
    RNGS,
    SCALE_TOL,
    nchw,
    numpy_variables,
    to_nhwc,
)
from test_torch_port_train import PARAM_TOL
from test_torch_port_train import jax_draws as jax_step_draws

BF16 = torch.bfloat16
FULL = 32  # CIFAR's side, for the full-width models
SIDE, PAD, BATCH, LR = 16, 2, 8, 0.01  # the small Bottleneck net's steps
# Two split V2 steps of the small Bottleneck net against JAX's. Its first
# step is held at the existing files' bounds: in f32 test_torch_port_train's
# (parameters at PARAM_TOL elementwise, BN statistics rtol 1e-4 / atol
# 1e-5), in bf16 test_torch_port_bf16's (each update within
# UPDATE_NORM_TOL, BN statistics at STEP_STATS_TOL). Its second step is
# ill-conditioned, more than ResNet9's in test_torch_port_train.py: under a
# 1e-6 relative perturbation of its own weights the port's f32 update moves
# up to 0.060 of a parameter's norm (the stem's BN bias), 0.017 of the
# whole update and 6.6e-4 in a BN statistic, and its bf16 update 0.42, 0.12
# and 0.027. The gaps to JAX are of that size: f32 0.060, 0.017 and 6.6e-4;
# bf16 0.52, 0.15 and 0.038, its loss 1.0 % from JAX's where the port's
# bf16 loss lies 0.8 % from its own f32 twin's. The bf16 whole update is
# 0.122 of its norm from JAX's after the first step already, at that
# spread. Bounds after the second step, and for the bf16 whole update after
# either: twice the port's own spread (for the bf16 parameters
# UPDATE_NORM_TOL); metrics at every step at the train step's rtol 1e-4 /
# atol 1e-5 in f32 and at twice the bf16-f32 gap in bf16.
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_BOUNDS = {  # dtype: (metrics, each update, whole update, BN stats)
    None: (STEP_TOL, 0.12, 0.035, dict(rtol=1e-4, atol=1.4e-3)),
    "bf16": (dict(rtol=2e-2, atol=1e-3), UPDATE_NORM_TOL, 0.24,
             dict(rtol=1e-2, atol=5.5e-2)),
}
FIRST_STEP_BOUNDS = {  # (parameters elementwise, each update, BN stats)
    None: (PARAM_TOL, None, dict(rtol=1e-4, atol=1e-5)),
    "bf16": (None, UPDATE_NORM_TOL, STEP_STATS_TOL),
}
SUBS = ("convbnrelu_1", "convbnrelu_2", "convbn_3", "shortcut")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files: the
    tier-1 run puts several pytest workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(flag=True):
    return {"flag": flag, "norm_type": "bn", "key_type": "random",
            "sign_loss": 0.1}


def _kwargs(path_or_config, key_type="random"):
    config = path_or_config
    if not isinstance(config, dict):
        config = load_passport_config(str(path_or_config))
    return jax_construct_passport_kwargs(config, "bn", key_type, 0.1)


def _shapes(jmodel, side, train=True):
    """The variable tree JAX's init gives ``jmodel`` at ``side``, as
    shapes: ``jax.eval_shape`` compiles nothing."""
    return jax.eval_shape(lambda x: jmodel.init(RNGS, x, train=train),
                          jax.ShapeDtypeStruct((1, side, side, 3),
                                               jnp.float32))


def _leaves(tree):
    return sorted((jax.tree_util.keystr(path), tuple(leaf.shape))
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      tree)[0])


def _full_width_variables(jmodel, pmodel, side, seed):
    """Variables for a full-width ``jmodel`` without flax's jitted init
    (several seconds a model on the CPU): ``pmodel``'s initial weights as
    the JAX tree, leaf for leaf the paths and shapes of JAX's init, BN
    statistics redrawn (numpy_variables)."""
    tree = export_jax_variables(pmodel)
    assert _leaves(tree) == _leaves(_shapes(jmodel, side))
    return numpy_variables(tree, seed)


def _x(n, side, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n, side, side, 3)).astype(np.float32)


# ---------------------------------------------------------------- blocks

BLOCK_CASES = {
    # name: (in_planes, stride, sub-blocks flagged, private, call kwargs)
    "normal_identity": (32, 1, None, False, {}),
    "normal_stride2": (32, 2, None, False, {}),
    "v1_stride2": (32, 2, SUBS, False, {}),
    "private_ind0": (32, 2, SUBS, True, {"ind": 0}),
    "private_ind1": (32, 2, SUBS, True, {"ind": 1}),
    "private_separate_stats": (32, 2, SUBS, True, {"ind": 1}),
    "private_identity_ind1": (32, 1, SUBS[:3], True, {"ind": 1}),
    "private_projection_stride1": (16, 1, SUBS, True, {"ind": 1}),
    "private_no_shortcut_key": (32, 2, SUBS[:3], True, {"ind": 1}),
}


def _block_pair(case):
    in_planes, stride, flagged, private, call = BLOCK_CASES[case]
    pk = None
    if flagged is not None:
        pk = {name: _leaf() for name in flagged}
        if case == "private_separate_stats":
            for leaf in pk.values():
                leaf["separate_stats"] = True
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, in_planes)).astype(np.float32)
    jblock = jax_resnet.Bottleneck(in_planes=in_planes, planes=8,
                                   stride=stride, passport_kwargs=pk,
                                   private=private)
    v = numpy_variables(jblock.init(RNGS, jnp.asarray(x), train=True),
                        seed=1)
    v["params"] = _moved_affines(v["params"], np.random.default_rng(2))
    pblock = Bottleneck(in_planes, 8, stride, "bn", pk, private,
                        input_hw=(8, 8)).eval()
    load_jax_variables(pblock, v)
    return jblock, v, pblock, x, call


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_bottleneck_matches_jax(case, train):
    jblock, v, pblock, x, call = _block_pair(case)
    in_planes, stride, flagged, private, _ = BLOCK_CASES[case]
    mutable = ["passport_aux"] + (["batch_stats"] if train else [])
    jy, upd = jblock.apply(v, jnp.asarray(x), train=train, mutable=mutable,
                           **call)
    seen = {}
    hooks = [getattr(pblock, name).register_forward_hook(
        lambda m, i, o, name=name: seen.update({name: o[0]}))
        for name in ("convbn_3", "shortcut") if getattr(pblock, name)]
    pblock.train(train)
    with torch.no_grad():
        y, aux = pblock(nchw(x), **call)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(to_nhwc(y), np.asarray(jy), **BLOCK_TOL)

    # the sub-blocks: the stride on the 3x3, a projection wherever the
    # shapes differ, no ReLU at convbn_3 and shortcut
    assert (pblock.convbnrelu_1.conv.strides, pblock.convbnrelu_2.conv.strides,
            pblock.convbn_3.conv.strides) == (1, stride, 1)
    assert (pblock.shortcut is None) == (stride == 1 and in_planes == 32) \
        == ("shortcut" not in v["params"])
    for name, out in seen.items():
        assert not getattr(pblock, name).relu and (out < 0).any(), name
    if case == "private_no_shortcut_key":  # a plain ConvBlock in the norm
        assert type(pblock.shortcut).__name__ == "ConvBlock"
        assert "shortcut" not in v.get("passport", {})

    jaux = collect_aux_with_paths(upd)
    assert list(aux) == [path for path, _ in jaux]
    for (path, ja), pa in zip(jaux, aux.values()):
        np.testing.assert_allclose(pa["scale"].numpy(), np.asarray(ja["scale"]),
                                   rtol=1e-5, atol=1e-6, err_msg=path)
    if train:
        want = jax_state_dict({"batch_stats": upd["batch_stats"]})
        got = {k: t.numpy() for k, t in pblock.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_passport_shapes_follow_each_position():
    """convbnrelu_1 and shortcut take the block input, convbnrelu_2 the
    (planes, H, W) map, convbn_3 the (planes, H/s, W/s) one."""
    pk = {name: _leaf() for name in SUBS}
    block = Bottleneck(16, 8, 2, "bn", pk, True, input_hw=(8, 8))
    assert tuple(block.convbnrelu_1.key.shape) == (1, 16, 8, 8)
    assert tuple(block.convbnrelu_2.key.shape) == (1, 8, 8, 8)
    assert tuple(block.convbn_3.key.shape) == (1, 8, 4, 4)
    assert tuple(block.shortcut.key.shape) == (1, 16, 8, 8)
    assert block.output_hw == (4, 4)
    assert [n for n, _ in block.named_children()] == list(SUBS)


# ------------------------------------------------ full-width ResNet-50

@pytest.fixture(scope="module")
def resnet50():
    """(JAX ResNet50Private, numpy variables, port model, plkeys) on equal
    weights, with resnet50_passport.json."""
    kw, plkeys = _kwargs(CONFIGS / "resnet50_passport.json")
    jmodel = jax_resnet.ResNet50Private(num_classes=10, passport_kwargs=kw)
    pmodel = build_model("resnet50", 10, passport_kwargs=kw, private=True,
                         device="cpu")
    v = _full_width_variables(jmodel, pmodel, FULL, 0)
    v["params"] = _moved_affines(v["params"], np.random.default_rng(0))
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel, plkeys


@pytest.mark.parametrize("ind", [0, 1])
def test_resnet50_logits_match_jax(resnet50, ind):
    jmodel, v, pmodel, _ = resnet50
    x = _x(2, FULL)
    want = _jax_logits(jmodel, v, x, ind=ind)
    got = Predictor(pmodel, ind=ind, device="cpu").logits(x).numpy()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_resnet50_private_forward_runs_k2_ten_times(resnet50, monkeypatch):
    """10 K2 calls (its plain version here) in a private forward, 4 of them
    without the ReLU, at (N,512,8,8) x1, (N,512,4,4) x5 and (N,2048,4,4)
    x4; none in a public one."""
    _, _, pmodel, _ = resnet50
    calls = []

    def spy(y, *args, relu=True, **kwargs):
        calls.append((tuple(y.shape), relu))
        return passport_epilogue(y, *args, relu=relu, **kwargs)

    monkeypatch.setattr(port_layers, "passport_epilogue", spy)
    Predictor(pmodel, ind=0, device="cpu").logits(_x(2, FULL))
    assert not calls
    Predictor(pmodel, ind=1, device="cpu").logits(_x(2, FULL))
    assert sorted(calls) == sorted(
        [((2, 512, 8, 8), True)] + [((2, 512, 4, 4), True)] * 5
        + [((2, 2048, 4, 4), False)] * 4)


def test_resnet50_derived_scales_and_rows_match_jax(resnet50):
    jmodel, v, pmodel, plkeys = resnet50
    shape = (1, FULL, FULL, 3)
    jaff = jax_derived_affines(jmodel, v, shape, private=True)
    paff = derived_affines(pmodel, shape, private=True)
    order = [jax_plkey_to_module_path(k) for k in plkeys]
    assert len(order) == 10 and list(paff) == order
    assert sorted(jaff) == sorted(order)
    for path in order:
        js = np.asarray(jaff[path]["scale"])
        ps = paff[path]["scale"].numpy()
        np.testing.assert_allclose(ps, js, err_msg=path, **SCALE_TOL)
        np.testing.assert_array_equal(np.sign(ps), np.sign(js))
    rows = make_signature_fn(pmodel, shape, True, device="cpu")()
    assert list(rows) == [f"private_{p}" for p in order]
    report = verify_ownership(pmodel, shape, True, device="cpu")
    assert report["layers"] == jax_detect(jaff) and report["verified"] is \
        (set(report["layers"].values()) == {1.0})
    assert sum(int(pmodel.get_submodule(p.replace("/", ".")).b.numel())
               for p in order) == 11264


def test_resnet50_config_and_fork_match_jax(resnet50):
    jmodel, v, pmodel, plkeys = resnet50
    cfg = load_passport_config(str(CONFIGS / "resnet50_passport.json"))
    assert construct_passport_kwargs(cfg, "bn", "random", 0.1) == \
        jax_construct_passport_kwargs(cfg, "bn", "random", 0.1)
    assert plkeys == [f"layer4.{b}.{s}" for b in range(3)
                      for s in SUBS if b == 0 or s != "shortcut"]
    fork = branch_point(pmodel)
    assert fork == jax_branch_point(jmodel)
    assert fork[0] == "layer4_0" and len(fork[1]) == 14
    params = sum(p.numel() for p in pmodel.parameters())
    assert params == sum(int(np.size(a)) for a in jax.tree.leaves(
        v["params"])) == 23_520_842


# ------------------------------------------------ interop on ResNet-50

@pytest.mark.parametrize("ind", [0, 1])
def test_resnet50_fold_matches_jax_and_the_unfolded_model(resnet50, ind):
    jmodel, v, pmodel, _ = resnet50
    x = _x(2, FULL)
    shape = (1, FULL, FULL, 3)
    jfm, jfv = jax_fold(jmodel, v, shape, ind=ind)
    want = _jax_logits(jfm, jfv, x)
    folded = Predictor(pmodel, ind=ind, folded=True, input_shape=shape,
                       device="cpu")
    got = folded.logits(x).numpy()
    np.testing.assert_allclose(got, want, **FOLD_TOL)
    unfolded = Predictor(pmodel, ind=ind, device="cpu").logits(x).numpy()
    np.testing.assert_allclose(got, unfolded, **FOLD_TOL)
    assert sorted(export_jax_variables(folded.model)) == sorted(jfv)
    assert folded.model.block_cls is Bottleneck


def test_resnet50_export_equals_jax_key_for_key_bit_for_bit(resnet50):
    jmodel, v, pmodel, _ = resnet50
    want = jax_export(jmodel, v)
    got = torch_export.export_torch_state_dict(pmodel)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert "layer4.0.convbn_3.key_private" in got
    assert "layer4.0.shortcut.sign_loss_private.b" in got
    # and JAX's file loads into a fresh port model bit for bit
    fresh = build_model("resnet50", 10, passport_kwargs=pmodel.passport_kwargs,
                        private=True, seed=5, device="cpu")
    torch_import.import_torch_state_dict(fresh, want)
    for k, t in pmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k


def test_resnet50_export_jax_variables_round_trip(resnet50):
    jmodel, v, pmodel, _ = resnet50
    tree = export_jax_variables(pmodel)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, v))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    again = build_model("resnet50", 10, passport_kwargs=pmodel.passport_kwargs,
                        private=True, seed=3, device="cpu")
    load_jax_variables(again, tree)
    for k, t in pmodel.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k
    x = _x(2, FULL)
    np.testing.assert_allclose(
        _jax_logits(jmodel, tree, x, ind=1),
        Predictor(again, ind=1, device="cpu").logits(x).numpy(), **LOGITS_TOL)


# ------------------------------------------------------------ ResNet-34

def _resnet34_layer4_config():
    """A ResNet-34 passport config that flags every position of layer4
    (block 0 with its shortcut) and none elsewhere: the repo ships none."""
    cfg = {"convbnrelu_1": False}
    for li, n in enumerate((3, 4, 6, 3), start=1):
        cfg[f"layer{li}"] = {
            str(b): {"convbnrelu_1": li == 4, "convbn_2": li == 4,
                     **({"shortcut": li == 4} if b == 0 else {})}
            for b in range(n)}
    return cfg


@pytest.mark.parametrize("config", [None, "layer4"])
def test_resnet34_logits_match_jax(tmp_path, config):
    kw = None
    if config is not None:
        path = tmp_path / "resnet34_passport.json"
        path.write_text(json.dumps(_resnet34_layer4_config()))
        kw, plkeys = _kwargs(path)
        assert len(plkeys) == 7
    jmodel = jax_registry.build_model("resnet34", 10, passport_kwargs=kw,
                                      private=kw is not None)
    pmodel = build_model("resnet34", 10, passport_kwargs=kw,
                         private=kw is not None, device="cpu")
    assert pmodel.block_cls is port_models.BasicBlock
    v = _full_width_variables(jmodel, pmodel, FULL, 1)
    load_jax_variables(pmodel, v)
    x = _x(2, FULL)
    kwargs = {} if kw is None else {"ind": 1}
    np.testing.assert_allclose(
        Predictor(pmodel, device="cpu", **kwargs).logits(x).numpy(),
        _jax_logits(jmodel, v, x, **kwargs), **LOGITS_TOL)


def test_registry_and_exports():
    """build_model takes the JAX package's archs and refuses the rest as
    it does; the package exports the JAX names."""
    new = {"Bottleneck", "ResNet34", "ResNet50", "ResNet50Passport",
           "ResNet50Private", "ResNet101", "ResNet152"}
    assert new <= set(port_models.__all__) <= set(jax_models.__all__)
    assert all(hasattr(port_models, name) for name in port_models.__all__)
    for arch in ("resnet34", "resnet50"):
        for private in (False, True):
            model = build_model(arch, 10, private=private, input_size=8,
                                device="cpu")
            assert model.block_cls.__name__ == (
                "BasicBlock" if arch == "resnet34" else "Bottleneck")
    for arch in ("resnet101", "resnet152", "vgg"):
        with pytest.raises(ValueError, match="unknown arch"):
            build_model(arch, 10, device="cpu")
        with pytest.raises(ValueError, match="unknown arch"):
            jax_registry.build_model(arch, 10)
    v1 = port_models.ResNet50Passport(
        passport_kwargs=_kwargs(CONFIGS / "resnet50_passport.json")[0],
        input_size=8)
    assert not v1.private and type(v1.layer4_0.convbn_3).__name__ == \
        "PassportBlock"


@pytest.mark.parametrize("arch", ["resnet101", "resnet152"])
def test_larger_factories_have_jax_variable_shapes(arch):
    make = {"resnet101": (jax_resnet.ResNet101, port_models.ResNet101),
            "resnet152": (jax_resnet.ResNet152, port_models.ResNet152)}[arch]
    shapes = jax.eval_shape(lambda x: make[0](num_classes=10).init(
        {"params": jax.random.key(0)}, x, train=True),
        jnp.zeros((1, FULL, FULL, 3)))
    # np.empty reserves no pages: the mapping, not the values, is checked
    want = {k: a.shape for k, a in jax_state_dict(jax.tree.map(
        lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    model = make[1](num_classes=10)
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    params = sum(int(np.prod(s.shape)) for s in
                 jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == params


# ------------------------------------------------ the small Bottleneck net

def _small_config():
    """ResNet(Bottleneck, (1, 1, 1, 1)) with every position of layer4
    flagged, shortcut included."""
    cfg = {"convbnrelu_1": False}
    for li in range(1, 5):
        cfg[f"layer{li}"] = {"0": {s: li == 4 for s in SUBS}}
    return cfg


@functools.lru_cache(maxsize=None)
def _small_jax(private, bf16, key_type, seed):
    """The JAX side of ``_small_pair``, initialised once per module."""
    kw = None
    if private is not None:
        kw, _ = _kwargs(_small_config(), key_type)
    jmodel = jax_resnet.ResNet(block_cls=jax_resnet.Bottleneck,
                               num_blocks=(1, 1, 1, 1), num_classes=10,
                               passport_kwargs=kw, private=bool(private),
                               dtype=jnp.bfloat16 if bf16 else None)
    v = numpy_variables(jax.jit(lambda x: jmodel.init(RNGS, x, train=True))(
        jnp.zeros((1, SIDE, SIDE, 3))), seed)
    return jmodel, v


def _small_pair(private=True, dtype=None, key_type="random", seed=0):
    """(JAX model, numpy variables, a fresh port model on the CPU) on equal
    weights: ResNet(Bottleneck, (1, 1, 1, 1)) at 16x16, ``private`` None
    for the normal net, else layer4 flagged (_small_config)."""
    jmodel, v = _small_jax(private, dtype is not None, key_type, seed)
    kw = jmodel.passport_kwargs
    pmodel = ResNet(Bottleneck, (1, 1, 1, 1), num_classes=10,
                    passport_kwargs=kw, private=bool(private),
                    input_size=SIDE, dtype=dtype)
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


def test_small_net_fork_and_key_setup_match_jax():
    jnormal, nv, pnormal = _small_pair(private=None, seed=4)
    jmodel, v, pmodel = _small_pair(key_type="shuffle")
    assert branch_point(pmodel) == jax_branch_point(jmodel) == (
        "layer4_0", ["convbnrelu_1", "layer1_0", "layer2_0", "layer3_0"])
    images = _x(40, SIDE, seed=5)
    kx = keys.sample_candidates(images, 20, seed=10)
    ky = keys.sample_candidates(images, 20, seed=11)
    want = jax_state_dict({"passport": jax.tree.map(
        np.asarray, jax_keys.setup_passports(jnormal, nv, v["passport"], kx,
                                             ky, seed=12))})
    got = keys.setup_passports(pnormal, pmodel, kx, ky, seed=12)
    assert sorted(got) == sorted(want) and len(got) == 8
    # the taps enter layer4 ten convolutions deep (PASSPORT_TOL was measured
    # four deep): held at the whole model's LOGITS_TOL
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name,
                                   **LOGITS_TOL)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (BATCH, SIDE, SIDE, 3))
             .astype(np.uint8),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)}
            for _ in range(2)]


def _held_against_jax(jstate, pmodel, start, param_tol, update_tol,
                      whole_tol, stats_tol):
    """The port's parameters and BN statistics against JAX's state:
    parameters elementwise at ``param_tol`` (if given), each update
    (from ``start``) within ``update_tol`` of its norm (if given), the
    whole update within ``whole_tol``, the statistics at ``stats_tol``."""
    params = dict(pmodel.named_parameters())
    want = jax_state_dict({"params": jstate.params})
    assert sorted(want) == sorted(params)
    diff, norm = [], []
    for name, w in want.items():
        assert params[name].dtype == torch.float32  # f32 master weights
        got = params[name].detach().numpy()
        if param_tol is not None:
            np.testing.assert_allclose(got, w, err_msg=name, **param_tol)
        moved = w - start[name].numpy()
        err = got - start[name].numpy() - moved
        if update_tol is not None:
            assert np.linalg.norm(err) <= update_tol * max(
                np.linalg.norm(moved), 1e-30), name
        diff.append(err.ravel())
        norm.append(moved.ravel())
    whole = (np.linalg.norm(np.concatenate(diff))
             / np.linalg.norm(np.concatenate(norm)))
    assert whole <= whole_tol, whole
    stats = jax_state_dict({"batch_stats": jstate.batch_stats})
    buffers = dict(pmodel.named_buffers())
    assert sorted(stats) == sorted(k for k in buffers
                                   if k.endswith(("_mean", "_var")))
    for name, w in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), w, err_msg=name,
                                   **stats_tol)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_small_net_split_v2_steps_match_jax(dtype):
    """Two split V2 steps on K1's output (its plain version; JAX's XLA
    stage) from the same weights and draws: metrics at each step; the
    parameters, each update and the whole update norm-wise, and the BN
    statistics after the first step at FIRST_STEP_BOUNDS and after the
    second at STEP_BOUNDS."""
    jmodel, v, pmodel = _small_pair(dtype=dtype)
    bf16 = dtype is not None
    case = "bf16" if bf16 else None
    metric_tol, update_tol, whole_tol, stats_tol = STEP_BOUNDS[case]
    first = FIRST_STEP_BOUNDS[case]
    start = {k: p.detach().clone() for k, p in pmodel.named_parameters()}
    jstep = jax_train_step(jmodel, True, device_augment=make_device_augment(
        PAD, out_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(LR))
    pstep = make_train_step(pmodel, True, pad=PAD, draws=jax_step_draws,
                            out_dtype=dtype or torch.float32, device="cpu")
    pstate = TrainState.create(pmodel, LR)
    for i, batch in enumerate(_batches()):
        jstate, jm = jstep(jstate, {k: jnp.asarray(a)
                                    for k, a in batch.items()})
        pstate, pm = pstep(pstate, batch)
        assert sorted(pm) == sorted(jm)
        assert float(pm["sign_acc"]) == float(jm["sign_acc"])
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), err_msg=k,
                                       **metric_tol)
        if i == 0:
            _held_against_jax(jstate, pmodel, start, first[0], first[1],
                              whole_tol, first[2])
    _held_against_jax(jstate, pmodel, start, None, update_tol, whole_tol,
                      stats_tol)


def test_small_net_attack3_step_matches_jax():
    """One step of attack 3 (10 % of the signature flipped, JAX's noise):
    the gradient reaches the fake passports through K2's backward, without
    the ReLU mask at convbn_3 and shortcut. The epoch's metrics at
    METRIC_TOL, each fake passport's update within UPDATE_TOL of its
    norm."""
    jmodel, v, pmodel = _small_pair()
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, v), jax_sgd(0.01))
    rng = np.random.default_rng(11)
    batches = [{"image": rng.normal(size=(4, SIDE, SIDE, 3)).astype(
        np.float32), "label": rng.integers(0, 10, 4).astype(np.int32)}]
    jfake, (jrow,) = jax_ambiguity.ambiguity_attack(
        jmodel, state, batches, batches, epochs=1, private=True,
        flipperc=0.1, lr=0.01, seed=0)
    noise = _jax_noise(jax.device_get(state.passport), 0)
    fake, (row,) = ambiguity.ambiguity_attack(
        pmodel, batches, batches, epochs=1, private=True, flipperc=0.1,
        lr=0.01, seed=0, noise=noise)
    assert set(row) == set(jrow)
    for k, w in jrow.items():
        np.testing.assert_allclose(row[k], w, err_msg=k, **METRIC_TOL)
    want = _port_tree(jfake)
    orig = passports(pmodel)
    assert set(want) == set(fake) and len(want) == 8
    for k, w in want.items():
        start = orig[k] + 0.001 * noise[k]
        err = ((fake[k] - w).norm() / (w - start).norm()).item()
        assert err <= UPDATE_TOL, (k, err)


def test_small_net_passport_to_normal_matches_jax():
    """V2 -> a BN normal model on Bottleneck names: copied weights and
    statistics, the derived affines in the passport layers' norms (convbn_3
    and shortcut among them)."""
    jmodel, v, pmodel = _small_pair()
    jnormal, nv, pnormal = _small_pair(private=None, seed=4)
    shape = (1, SIDE, SIDE, 3)
    plkeys = [f"layer4.0.{sub}" for sub in SUBS]
    jaff = jax_derived_affines(jmodel, v, shape, True)
    jp, js = jax_surgery.passport_to_normal(
        v["params"], v["batch_stats"], jaff, nv["params"], nv["batch_stats"],
        [jax_plkey_to_module_path(k) for k in plkeys])
    plpaths = [k.replace("layer4.0", "layer4_0") for k in plkeys]
    got = surgery.passport_to_normal(
        pmodel.state_dict(), derived_affines(pmodel, shape, True),
        pnormal.state_dict(), plpaths)
    want = jax_state_dict({"params": jax.device_get(jp),
                           "batch_stats": jax.device_get(js)})
    assert set(got) == set(want)
    derived = {f"{p}.bn.{k}" for p in plpaths for k in ("weight", "bias")}
    for k, w in want.items():
        tol = SCALE_TOL if k in derived else dict(rtol=0, atol=0)
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **tol)
    pnormal.load_state_dict(got)


def test_small_net_remat_full_equals_none():
    """remat="full" on Bottleneck units: two split V2 steps bit for bit with
    remat="none" (the recomputation takes no BN EMA step)."""
    states = []
    for remat in ("none", "full"):
        _, _, pmodel = _small_pair()
        step = make_train_step(pmodel, True, pad=PAD, draws=jax_step_draws,
                               remat=remat, device="cpu")
        state = TrainState.create(pmodel, LR)
        for batch in _batches():
            state, _ = step(state, batch)
        states.append(pmodel.state_dict())
    for k, t in states[0].items():
        assert torch.equal(states[1][k], t), k


# ---------------------------------------------------------- torchvision

def _tv_bn(rng, sd, prefix, c):
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)
    sd[f"{prefix}.num_batches_tracked"] = np.array(0)


def tv_resnet_sd(rng, arch):
    """torchvision ResNet-34's or ResNet-50's keys and shapes (the layout of
    tests/test_torchvision_import.py), random values."""
    def conv(co, ci, k):
        return rng.normal(0, (2 / (co * k * k)) ** 0.5, (co, ci, k, k))

    bottleneck = arch == "resnet50"
    expansion = 4 if bottleneck else 1
    sd = {"conv1.weight": conv(64, 3, 7)}
    _tv_bn(rng, sd, "bn1", 64)
    cin = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)),
                                     start=1):
        cout = planes * expansion
        for b in range(n):
            c1_in = cin if b == 0 else cout
            p = f"layer{li}.{b}"
            if bottleneck:
                sd[f"{p}.conv1.weight"] = conv(planes, c1_in, 1)
                sd[f"{p}.conv2.weight"] = conv(planes, planes, 3)
                sd[f"{p}.conv3.weight"] = conv(cout, planes, 1)
                for bn, ch in (("bn1", planes), ("bn2", planes),
                               ("bn3", cout)):
                    _tv_bn(rng, sd, f"{p}.{bn}", ch)
            else:
                sd[f"{p}.conv1.weight"] = conv(cout, c1_in, 3)
                sd[f"{p}.conv2.weight"] = conv(cout, cout, 3)
                for bn in ("bn1", "bn2"):
                    _tv_bn(rng, sd, f"{p}.{bn}", cout)
            if b == 0 and (li != 1 or bottleneck):
                sd[f"{p}.downsample.0.weight"] = conv(cout, cin, 1)
                _tv_bn(rng, sd, f"{p}.downsample.1", cout)
        cin = cout
    sd["fc.weight"] = rng.normal(0, cin ** -0.5, (1000, cin))
    sd["fc.bias"] = rng.normal(0, 0.1, 1000)
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("tracked") else np.float32))
        for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["resnet34", "resnet50"])
def test_torchvision_import_matches_jax(tmp_path, arch):
    """A hand-built torchvision state dict through load_torch_pretrained
    against JAX import_torchvision, on the ImageNet stem at 64 px (224 px
    runs on the card)."""
    side = 64
    sd = tv_resnet_sd(np.random.default_rng(5), arch)
    make = {"resnet34": jax_resnet.ResNet34,
            "resnet50": jax_resnet.ResNet50}[arch]
    jmodel = make(num_classes=1000, imagenet=True)
    # the strict import overwrites every leaf of the template
    tmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        _shapes(jmodel, side, train=False))
    jv = jax_import_torchvision(sd, tmpl, arch)
    x = _x(2, side)
    want = _jax_logits(jmodel, jv, x)
    path = str(tmp_path / f"tv_{arch}.pth")
    torch.save(sd, path)
    pmodel = build_model(arch, 1000, imagenet=True, input_size=side,
                         device="cpu")
    torchvision_import.load_torch_pretrained(path, pmodel, arch)
    assert torch.equal(pmodel.linear.weight, sd["fc.weight"])
    if arch == "resnet50":  # the stride on the 3x3, as torchvision's
        assert torch.equal(pmodel.layer2_0.convbnrelu_2.conv.weight,
                           sd["layer2.0.conv2.weight"])
    got = Predictor(pmodel, device="cpu").logits(x).numpy()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


# ------------------------------------------------------------ the CLIs

def test_train_clis_run_resnet50(tmp_path):
    """cli.train_v1 --arch resnet50 scheme 0, then cli.train_v23 V2 with
    resnet50_passport.json from its last.ckpt (shuffle keys, the
    device-resident epoch through K1's plain version), one epoch each on
    64 synthetic images, then --eval of it: the history has JAX's columns
    (sorted, as JAX's append_history writes them) with the 10 detection
    columns."""
    common = ["--arch", "resnet50", "--dataset", "synthetic", "--batch-size",
              "32", "--epochs", "1", "--lr-config", "lr_configs/finetune.json",
              "--logdir", str(tmp_path / "logs")]
    sizes = {"synthetic_train": 64, "synthetic_test": 32}
    run0 = train_v1.main(common, device="cpu", **sizes)
    assert run0.model.block_cls is Bottleneck and not run0.plkeys
    ckpt = os.path.join(run0.logdir, "models", "last.ckpt")
    v2 = common + ["--passport-config", str(CONFIGS / "resnet50_passport.json"),
                   "--key-type", "shuffle", "--pretrained-path", ckpt,
                   "--epoch-scan", "--pallas-input"]
    run2 = train_v23.main(v2, device="cpu", **sizes)
    assert run2.logdir.endswith(os.path.join("resnet50_synthetic_v2", "1"))
    evaluated = train_v23.main(v2 + ["--eval", "--exp-id", "1"],
                               device="cpu", **sizes).evaluate_only()
    assert all(np.isfinite(v) for v in evaluated.values())
    with open(os.path.join(run2.logdir, "history.csv")) as f:
        header, row = list(csv.reader(f))
    _, plkeys = _kwargs(CONFIGS / "resnet50_passport.json")
    detection = [f"s_private_{jax_plkey_to_module_path(k)}" for k in plkeys]
    want = sorted(V2_COLUMNS + detection)
    assert header == want
    assert all(np.isfinite(float(v)) for v in row)


# the columns of a V2 run's history.csv besides the detection rows, as the
# JAX package writes them (test_torch_port_cli.py holds the port's to a JAX
# run); they do not depend on the architecture
V2_COLUMNS = ["train_acc_private", "train_acc_public", "train_images_per_sec",
              "train_loss", "train_sign_acc", "train_sign_loss", "train_time",
              "valid_acc_private", "valid_acc_public", "valid_loss_private",
              "valid_loss_public", "valid_total_acc"]
