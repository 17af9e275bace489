"""The port's interop against the JAX package's, on equal weights, on the CPU:
inference folding, reference-layout .pth export and import, torchvision
import, and the port -> JAX variable tree.

Models are initialised by flax, their BN statistics redrawn with numpy and
their learned affines (BN scale/bias, the passport blocks' public
scale/bias) moved off their initial values, then loaded into the port with
``load_jax_variables``.

- Fold: the port's folded logits against JAX ``fold_for_inference``'s and
  against the port's unfolded ``Predictor`` at rtol/atol 1e-4
  (tests/test_fold.py), for V1, V2 ind 0 and 1, a normal ResNet,
  resnet18_passport.json, and a separate-stats model's ind 1; GN raises.
- .pth export: ``export_torch_state_dict`` equal to JAX's key for key and
  value for value.
- .pth import: a JAX-written file loads into the port, and the port's into
  JAX ``load_torch_checkpoint``, with logits at LOGITS_TOL
  (tests/test_torch_port_model.py); JAX's classifier column reorder would
  give other logits; an unmatched passport or signature entry raises.
- torchvision: hand-built AlexNet and ResNet18 state dicts (random values in
  the layout of tests/test_torchvision_import.py) against JAX
  ``import_torchvision`` at 224 px: the first JAX hold of the ImageNet
  ResNet stem and its 7x7 layer4.
- ``export_jax_variables``: the inverse of ``load_jax_variables``, bit for
  bit, and JAX's logits on it, a whole separate-stats model included (W6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepipr_tpu.interop.fold import fold_for_inference as jax_fold
from deepipr_tpu.interop.torch_export import (
    export_torch_state_dict as jax_export,
    save_torch_checkpoint as jax_save_torch_checkpoint,
)
from deepipr_tpu.interop.torch_import import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
)
from deepipr_tpu.interop.torchvision_import import (
    import_torchvision as jax_import_torchvision,
)
from deepipr_tpu.models import alexnet as jax_alexnet
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
    mark_separate_stats,
)

from deepipr_tpu_torch.cli import passport_attack_1
from deepipr_tpu_torch.interop import fold, torch_export, torch_import
from deepipr_tpu_torch.interop import torchvision_import
from deepipr_tpu_torch.interop.jax_params import (
    export_jax_variables,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.serve import Predictor, verify_ownership
from deepipr_tpu_torch.train import experiment

from test_torch_port_experiment import base_args
from test_torch_port_model import CONFIGS, RNGS, LOGITS_TOL, nchw, \
    numpy_variables

SIDE = 16  # ResNet's; AlexNet's is 32, the side of its flattened
# classifier's (C, H, W) in interop/jax_params.py
FOLD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_fold.py


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the module, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kwargs(config, separate_stats=False):
    if config is None:
        return None
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / config)), "bn", "random", 0.1)
    if separate_stats:
        mark_separate_stats(kw)
    return kw


def _moved_affines(tree, rng):
    """Learned scale/bias leaves of a params tree off their init values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _moved_affines(v, rng)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "bias" and v.ndim == 1:
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def pair(arch, config=None, private=True, num_classes=10, imagenet=False,
         side=None, separate_stats=False, norm_type="bn", seed=0):
    """(JAX model, numpy variables, port model on the CPU) on equal
    weights; ``side`` by default 32 for AlexNet and SIDE for ResNet."""
    side = side or (32 if arch == "alexnet" else SIDE)
    kw = _kwargs(config, separate_stats)
    common = dict(num_classes=num_classes, passport_kwargs=kw,
                  private=private, imagenet=imagenet, norm_type=norm_type)
    if arch == "alexnet":
        jmodel = jax_alexnet.AlexNet(**common)
    else:
        jmodel = {"resnet9": jax_resnet.ResNet9,
                  "resnet18": jax_resnet.ResNet18}[arch](**common)
    v = jax.jit(lambda x: jmodel.init(RNGS, x, train=True))(
        jnp.zeros((1, side, side, 3)))
    v = numpy_variables(v, seed)
    v["params"] = _moved_affines(v["params"], np.random.default_rng(seed))
    pmodel = build_model(arch, num_classes, norm_type, passport_kwargs=kw,
                         private=private, imagenet=imagenet, input_size=side,
                         device="cpu")
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel


@pytest.fixture(scope="module")
def pairs():
    """pair by its arguments, each built once per module."""
    cache = {}

    def get(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in cache:
            cache[key] = pair(*args, **kwargs)
        return cache[key]

    return get


def _images(n=4, side=SIDE, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n, side, side, 3)).astype(np.float32)


# One jitted eval apply per model definition and branch, shared by the fold,
# export and import cases: equal reprs are equal flax models (every field
# is in the repr), so their applies are the same function
_APPLY = {}


def _jax_logits(jmodel, variables, x, **kwargs):
    key = (repr(jmodel), tuple(sorted(kwargs.items())))
    if key not in _APPLY:
        _APPLY[key] = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, **kwargs))
    return np.asarray(_APPLY[key](jax.tree.map(jnp.asarray, variables),
                                  jnp.asarray(x)))


# ------------------------------------------------------------------ fold

FOLD_CASES = {
    # name: (pair arguments, ind)
    "v1_alexnet": (("alexnet", "alexnet_passport.json", False), 0),
    "v2_alexnet_ind0": (("alexnet", "alexnet_passport.json", True), 0),
    "v2_alexnet_ind1": (("alexnet", "alexnet_passport.json", True), 1),
    "normal_resnet9": (("resnet9", None, False), 0),
    "resnet18_passport_ind0": (("resnet18", "resnet18_passport.json",
                                True), 0),
    "resnet18_passport_ind1": (("resnet18", "resnet18_passport.json",
                                True), 1),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES) + ["separate_stats_ind1"])
def test_fold_matches_jax_and_the_unfolded_model(pairs, case):
    if case == "separate_stats_ind1":
        args, kwargs, ind = ("resnet9", "resnet9_passport.json", True), \
            {"separate_stats": True}, 1
    else:
        (args, ind), kwargs = FOLD_CASES[case], {}
    jmodel, v, pmodel = pairs(*args, **kwargs)
    if kwargs:  # the private statistics apart from the public ones
        assert any(".bn_private." in k for k in pmodel.state_dict())
    side = pmodel.input_size
    x = _images(side=side)
    shape = (1, side, side, 3)

    jfm, jfv = jax_fold(jmodel, v, shape, ind=ind)
    want = _jax_logits(jfm, jfv, x)
    folded = Predictor(pmodel, ind=ind, folded=True, input_shape=shape,
                       device="cpu")
    got = folded.logits(x).numpy()
    np.testing.assert_allclose(got, want, **FOLD_TOL)
    unfolded = Predictor(pmodel, ind=ind, device="cpu").logits(x).numpy()
    np.testing.assert_allclose(got, unfolded, **FOLD_TOL)

    # the deployment artifact: conv weights and biases and the head only
    names = folded.model.state_dict()
    assert not [k for k in names if k.rsplit(".", 1)[-1] in (
        "key", "skey", "b", "running_mean", "running_var", "scale")]
    assert folded.model.norm_type == "none"
    assert sorted(export_jax_variables(folded.model)) == sorted(jfv)
    assert folded.ind == 0 and not folded.force_passport


def test_fold_default_input_shape_and_the_model_unchanged(pairs):
    _, _, pmodel = pairs("alexnet", "alexnet_passport.json", True)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    a = fold.fold_for_inference(pmodel, ind=1)
    b = fold.fold_for_inference(pmodel, (1, 32, 32, 3), ind=1)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_fold_rejects_groupnorm():
    jmodel = jax_alexnet.AlexNet(num_classes=10, norm_type="gn")
    with pytest.raises(ValueError, match="norm_type"):  # before any variable
        jax_fold(jmodel, {"params": {}}, (1, SIDE, SIDE, 3))
    pmodel = build_model("alexnet", 10, "gn", input_size=SIDE, device="cpu")
    with pytest.raises(ValueError, match="norm_type"):
        fold.fold_for_inference(pmodel)
    with pytest.raises(ValueError, match="norm_type"):
        Predictor(pmodel, folded=True, device="cpu")


# ------------------------------------------------------------ .pth export

EXPORT_CASES = {
    # name: pair arguments
    "alexnet_v2": ("alexnet", "alexnet_passport.json", True),
    "alexnet_v1": ("alexnet", "alexnet_passport.json", False),
    "resnet9_v2": ("resnet9", "resnet9_passport.json", True),
    "resnet9_imagenet_stem": ("resnet9", None, False),
}


def _export_pair(pairs, case):
    args = EXPORT_CASES[case]
    if case == "resnet9_imagenet_stem":
        return pairs(*args, imagenet=True, side=32)
    return pairs(*args)


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_export_equals_jax_key_for_key_bit_for_bit(pairs, case):
    jmodel, v, pmodel = _export_pair(pairs, case)
    want = jax_export(jmodel, v)
    got = torch_export.export_torch_state_dict(pmodel)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    if case == "resnet9_imagenet_stem":
        assert "convbnrelu_1.0.conv.weight" in got
    if case == "alexnet_v2":
        assert "features.4.key_private" in got and \
            "features.4.sign_loss_private.b" in got


def test_export_refuses_separate_stats(pairs):
    jmodel, v, pmodel = pairs("resnet9", "resnet9_passport.json", True,
                              separate_stats=True)
    with pytest.raises(ValueError, match="separate_stats"):
        jax_export(jmodel, v)
    with pytest.raises(ValueError, match="separate_stats"):
        torch_export.export_torch_state_dict(pmodel)


# ------------------------------------------------------------ .pth import

@pytest.mark.parametrize("case", ["alexnet_v2", "resnet9_v2",
                                  "resnet9_imagenet_stem"])
def test_pth_files_load_across_both_ways(pairs, tmp_path, case):
    jmodel, v, pmodel = _export_pair(pairs, case)
    side = pmodel.input_size
    x = _images(side=side)
    kwargs = {"ind": 1} if pmodel.private else {}
    want = _jax_logits(jmodel, v, x, **kwargs)

    # JAX writes, the port reads
    path = str(tmp_path / "jax.pth")
    jax_save_torch_checkpoint(path, jmodel, v)
    arch, config, _ = EXPORT_CASES[case]
    fresh = build_model(arch, 10, passport_kwargs=_kwargs(config),
                        private=pmodel.private,
        imagenet=case == "resnet9_imagenet_stem", input_size=side, seed=7,
        device="cpu")
    torch_import.load_torch_checkpoint(path, fresh)
    for k, t in pmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    np.testing.assert_allclose(
        Predictor(fresh, device="cpu", **kwargs).logits(x).numpy(), want,
        **LOGITS_TOL)
    if pmodel.private:
        shape = (1, side, side, 3)
        assert verify_ownership(fresh, shape, True, device="cpu")["layers"] \
            == verify_ownership(pmodel, shape, True, device="cpu")["layers"]

    # the port writes, JAX reads
    path = str(tmp_path / "port.pth")
    torch_export.save_torch_checkpoint(path, pmodel)
    zeros = jax.tree.map(np.zeros_like, v)
    jv = jax_load_torch_checkpoint(path, zeros)
    np.testing.assert_allclose(_jax_logits(jmodel, jv, x, **kwargs), want,
                               **LOGITS_TOL)


def test_jax_column_reorder_gives_other_logits(pairs):
    """The trap: the port flattens (c, h, w) like the reference, so the
    classifier loads as it is; JAX's (c, h, w) -> (h, w, c) reorder of its
    columns (torch_import.py:32-44) moves the logits."""
    jmodel, v, pmodel = pairs("alexnet", "alexnet_passport.json", True)
    sd = jax_export(jmodel, v)
    w = sd["classifier.weight"]
    c, h, wd = 256, 4, 4
    sd["classifier.weight"] = w.reshape(-1, c, h, wd).permute(
        0, 2, 3, 1).reshape(w.shape[0], -1)
    reordered = build_model("alexnet", 10, passport_kwargs=_kwargs(
        "alexnet_passport.json"), private=True, device="cpu")
    torch_import.import_torch_state_dict(reordered, sd)
    x = _images(side=32)
    want = Predictor(pmodel, device="cpu").logits(x)
    got = Predictor(reordered, device="cpu").logits(x)
    assert not torch.allclose(got, want, **LOGITS_TOL)


@pytest.mark.parametrize("entry", ["features.4.key_private",
                                   "features.5.sign_loss_private.b",
                                   "features.6.b", "features.4.bn.running_var"])
def test_unmatched_passport_or_signature_entries_raise(pairs, entry):
    _, _, pmodel = pairs("alexnet", "alexnet_passport.json", True)
    sd = torch_export.export_torch_state_dict(pmodel)
    target = build_model("alexnet", 10, passport_kwargs=_kwargs(
        "alexnet_passport.json"), private=True, device="cpu")
    del sd[entry]
    if entry.endswith("sign_loss_private.b"):
        # the reference's copy of b: ignored on import, as in JAX
        torch_import.import_torch_state_dict(target, sd)
        return
    match = "lacks model entries" if "running" in entry else \
        "passport or signature entries"
    with pytest.raises(ValueError, match=match):
        torch_import.import_torch_state_dict(target, sd)


def test_extra_entries_are_dropped_loudly(pairs, capsys):
    _, _, pmodel = pairs("alexnet", "alexnet_passport.json", True)
    sd = torch_export.export_torch_state_dict(pmodel)
    sd["features.4.extra_statistic"] = torch.zeros(3)
    target = build_model("alexnet", 10, passport_kwargs=_kwargs(
        "alexnet_passport.json"), private=True, device="cpu")
    torch_import.import_torch_state_dict(target, sd)
    assert ("WARNING: torch_import dropped 1 checkpoint entry not in the "
            "template: ['features_4.extra_statistic']") in \
        capsys.readouterr().out


# ------------------------------------------------------------ torchvision

def _tv_alexnet_sd(rng):
    """torchvision AlexNet's keys and shapes, random values."""
    convs = {"0": (64, 3, 11), "3": (192, 64, 5), "6": (384, 192, 3),
             "8": (256, 384, 3), "10": (256, 256, 3)}
    sd = {}
    for i, (co, ci, k) in convs.items():
        sd[f"features.{i}.weight"] = rng.normal(
            0, (2 / (co * k * k)) ** 0.5, (co, ci, k, k))
        sd[f"features.{i}.bias"] = rng.normal(0, 0.1, co)
    for i, (o, n) in {"1": (4096, 9216), "4": (4096, 4096),
                      "6": (1000, 4096)}.items():
        sd[f"classifier.{i}.weight"] = rng.normal(0, n ** -0.5, (o, n))
        sd[f"classifier.{i}.bias"] = rng.normal(0, 0.1, o)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def _tv_bn(rng, sd, prefix, c):
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)
    sd[f"{prefix}.num_batches_tracked"] = np.array(0)


def _tv_resnet18_sd(rng):
    """torchvision ResNet-18's keys and shapes, random values."""
    def conv(co, ci, k):
        return rng.normal(0, (2 / (co * k * k)) ** 0.5, (co, ci, k, k))

    sd = {"conv1.weight": conv(64, 3, 7)}
    _tv_bn(rng, sd, "bn1", 64)
    chans = {"layer1": (64, 64), "layer2": (64, 128),
             "layer3": (128, 256), "layer4": (256, 512)}
    for layer, (cin, cout) in chans.items():
        for b in range(2):
            c1_in = cin if b == 0 else cout
            sd[f"{layer}.{b}.conv1.weight"] = conv(cout, c1_in, 3)
            sd[f"{layer}.{b}.conv2.weight"] = conv(cout, cout, 3)
            for bn in ("bn1", "bn2"):
                _tv_bn(rng, sd, f"{layer}.{b}.{bn}", cout)
            if b == 0 and layer != "layer1":
                sd[f"{layer}.0.downsample.0.weight"] = conv(cout, cin, 1)
                _tv_bn(rng, sd, f"{layer}.0.downsample.1", cout)
    sd["fc.weight"] = rng.normal(0, 512 ** -0.5, (1000, 512))
    sd["fc.bias"] = rng.normal(0, 0.1, 1000)
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("tracked") else np.float32))
        for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["alexnet", "resnet18"])
def test_torchvision_import_matches_jax_at_224(tmp_path, arch):
    rng = np.random.default_rng(5)
    if arch == "alexnet":
        sd = _tv_alexnet_sd(rng)
        jmodel = jax_alexnet.AlexNet(num_classes=1000, norm_type="none")
        norm_type = "none"
    else:
        sd = _tv_resnet18_sd(rng)
        jmodel = jax_resnet.ResNet18(num_classes=1000)
        norm_type = "bn"
    x = _images(2, side=224)
    tmpl = jax.jit(lambda x: jmodel.init(RNGS, x, train=False))(
        jnp.zeros((1, 224, 224, 3)))
    jv = jax_import_torchvision(sd, jax.tree.map(np.asarray, dict(tmpl)),
                                arch)
    want = _jax_logits(jmodel, jv, x)

    path = str(tmp_path / f"tv_{arch}.pth")
    torch.save(sd, path)
    pmodel = build_model("resnet" if arch == "resnet18" else arch, 1000,
                         norm_type, input_size=224, device="cpu")
    torchvision_import.load_torch_pretrained(path, pmodel, arch)
    if arch == "resnet18":  # the ImageNet stem and layer4 at 7x7
        assert pmodel.is_imagenet
        taps = {}
        pmodel.layer4_1.register_forward_hook(
            lambda m, i, o: taps.update(layer4=o[0].shape))
    got = Predictor(pmodel, device="cpu").logits(x).numpy()
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    if arch == "resnet18":
        assert tuple(taps["layer4"]) == (2, 512, 7, 7)
    with pytest.raises(ValueError, match="unsupported torchvision arch"):
        torchvision_import.import_torchvision(sd, pmodel, "vgg16")


# --------------------------------------------------------- load sites

def test_pretrained_pth_loads_at_every_load_site(pairs, tmp_path,
                                                 monkeypatch):
    """--pretrained-path of the experiment (scheme 0 and its key setup) and
    of attack 1 take a reference-layout .pth of a normal model."""
    _, _, normal = pairs("resnet9", None, False, side=32)
    path = str(tmp_path / "normal.pth")
    torch_export.save_torch_checkpoint(path, normal)
    want = normal.state_dict()

    exp = experiment.ClassificationExperiment(base_args(
        tmp_path, pretrained_path=path), "cpu")
    for k, v in want.items():
        assert torch.equal(exp.model.state_dict()[k], v), k

    seen = {}
    monkeypatch.setattr(experiment, "setup_passports",
                        lambda pre, model, kx, ky, seed: seen.update(
                            pretrained=pre) or {})
    with pytest.raises(ValueError, match="key setup"):
        experiment.ClassificationExperiment(base_args(
            tmp_path, pretrained_path=path, train_private=True,
            key_type="shuffle"), "cpu")
    for k, v in want.items():
        assert torch.equal(seen["pretrained"].state_dict()[k], v), k

    import deepipr_tpu_torch.attacks as port_attacks
    monkeypatch.setattr(port_attacks, "random_passport_attack",
                        lambda model, pre, *a, **k: seen.update(
                            attack=pre) or [])
    monkeypatch.chdir(tmp_path)
    passport_attack_1.main(
        ["--arch", "resnet9", "--dataset", "synthetic", "--scheme", "2",
         "--passport-config", str(CONFIGS / "resnet9_passport.json"),
         "--pretrained-path", path], device="cpu", synthetic_train=64,
        synthetic_test=32)
    for k, v in want.items():
        assert torch.equal(seen["attack"].state_dict()[k], v), k


# ------------------------------------------------------- port -> JAX

@pytest.mark.parametrize("case", ["alexnet_v2", "resnet9_v1",
                                  "resnet9_separate_stats"])
def test_export_jax_variables_round_trip(pairs, case):
    if case == "alexnet_v2":
        jmodel, v, pmodel = pairs("alexnet", "alexnet_passport.json", True)
    elif case == "resnet9_v1":
        jmodel, v, pmodel = pairs("resnet9", "resnet9_passport.json", False)
    else:
        jmodel, v, pmodel = pairs("resnet9", "resnet9_passport.json", True,
                                  separate_stats=True)
    tree = export_jax_variables(pmodel)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, v))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    again = build_model(case.split("_")[0], 10,
                        passport_kwargs=pmodel.passport_kwargs,
                        private=pmodel.private,
                        input_size=pmodel.input_size, seed=3,
                        device="cpu")
    load_jax_variables(again, tree)
    for k, t in pmodel.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k
    x = _images(side=pmodel.input_size)
    for ind in ((0, 1) if pmodel.private else (0,)):
        kwargs = {"ind": ind} if pmodel.private else {"force_passport": True}
        np.testing.assert_allclose(
            _jax_logits(jmodel, tree, x, **kwargs),
            pmodel(nchw(x), **kwargs).logits.detach().numpy(), **LOGITS_TOL)
