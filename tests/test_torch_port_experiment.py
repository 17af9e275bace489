"""The port's key setup, checkpoints and experiment pieces against the JAX
package's, on the CPU: passport selection, candidate sampling and layer
seeds; passports from a pretrained model's taps on equal weights; the
checkpoint round trip, pretrained loading and resume; scheme derivation,
the expid, the failure guards and the CLI's parser.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import train_v1 as jax_train_v1
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.passport.selection import (
    passport_selection as jax_passport_selection,
    random_passport as jax_random_passport,
)
from deepipr_tpu.train import keys as jax_keys
from deepipr_tpu.train.experiment import derive_scheme as jax_derive_scheme
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
    mark_separate_stats as jax_mark_separate_stats,
)

from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.passport.selection import (
    passport_selection,
    random_passport,
)
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train import experiment, keys
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_train_step
from deepipr_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer,
    load_state,
    save_state,
)
from deepipr_tpu_torch.utils.config import mark_separate_stats

from test_torch_port_data import published  # noqa: F401 (a fixture)
from test_torch_port_model import CONFIGS, RNGS, numpy_variables

SIDE = 16
# Passports are block inputs of the pretrained model on the candidates:
# taps after up to four convolutions with train-mode BN, held at the
# tolerance of the port's blocks (tests/test_torch_port_model.py, BLOCK_TOL)
# scaled by depth; measured worst 1.4e-5 absolute on values up to 6.8.
PASSPORT_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test: the tier-1 run puts several pytest
    workers on the same cores, where bf16 CPU kernels spinning on eight
    threads each slowed one test from seconds to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _v2_kwargs(key_type="shuffle"):
    return construct_passport_kwargs(
        load_passport_config(str(CONFIGS / "resnet9_passport.json")), "bn",
        key_type, 0.1)[0]


# ------------------------------------------------------------ selection

@pytest.mark.parametrize("b,c", [(20, 64), (3, 128), (1, 16), (5, 3)])
def test_passport_selection_matches_jax(b, c):
    rng = np.random.default_rng(b * c)
    cand = rng.normal(size=(b, 4, 4, c)).astype(np.float32)
    want = jax_passport_selection(cand, seed=17)
    got = passport_selection(np.ascontiguousarray(cand.transpose(0, 3, 1, 2)),
                             seed=17)
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(random_passport((b, c, 4, 4), seed=3),
                                  jax_random_passport((b, c, 4, 4), seed=3))


def test_sample_candidates_and_layer_seed_match_jax():
    images = np.random.default_rng(0).normal(size=(64, 8, 8, 3))
    for n, seed in ((20, 10), (1, 11), (64, 0)):
        np.testing.assert_array_equal(
            keys.sample_candidates(images, n, seed),
            jax_keys.sample_candidates(images, n, seed))
    for path in ("layer4_0/convbnrelu_1", "features_4", "convbnrelu_1"):
        for which in ("key", "skey"):
            assert keys._layer_seed(12, path, which) == \
                jax_keys._layer_seed(12, path, which)


def test_mark_separate_stats_matches_jax():
    a, b = _v2_kwargs(), _v2_kwargs()
    mark_separate_stats(a)
    jax_mark_separate_stats(b)
    assert a == b
    assert a["layer4"]["0"]["convbn_2"]["separate_stats"] is True


# --------------------------------------------------- key setup vs JAX

@pytest.fixture(scope="module")
def pretrained_pair():
    """A normal ResNet9 in JAX and in the port on equal weights (BN
    statistics redrawn), and the candidates of both passport sides."""
    jmodel = jax_resnet.ResNet9(num_classes=10)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((2, SIDE, SIDE, 3)),
                                    train=True), seed=4)
    pmodel = build_model("resnet9", 10, input_size=SIDE, device="cpu")
    load_jax_variables(pmodel, v)
    images = np.random.default_rng(5).normal(size=(40, SIDE, SIDE, 3)) \
        .astype(np.float32)
    kx = keys.sample_candidates(images, 20, seed=10)
    ky = keys.sample_candidates(images, 20, seed=11)
    return jmodel, v, pmodel, kx, ky


def test_setup_passports_matches_jax_on_equal_weights(pretrained_pair):
    jmodel, v, pmodel, kx, ky = pretrained_pair
    kw = _v2_kwargs()
    jtarget = jax_resnet.ResNet9(num_classes=10, passport_kwargs=kw,
                                 private=True)
    jpass = jtarget.init(RNGS, jnp.zeros((1, SIDE, SIDE, 3)),
                         train=True)["passport"]
    want = jax_state_dict({"passport": jax.tree.map(
        np.asarray, jax_keys.setup_passports(jmodel, v, jpass, kx, ky,
                                             seed=12))})
    target = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                         input_size=SIDE, device="cpu")
    before = {k: b.clone() for k, b in pmodel.named_buffers()}
    got = keys.setup_passports(pmodel, target, kx, ky, seed=12)
    assert sorted(got) == sorted(want) == sorted(passports(target))
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, err_msg=name,
                                   **PASSPORT_TOL)
    # the tap pass runs in train mode and puts the statistics back
    for k, b in pmodel.named_buffers():
        assert torch.equal(b, before[k]), k
    assert not pmodel.training


def test_collect_taps_names_every_block(pretrained_pair):
    jmodel, v, pmodel, kx, _ = pretrained_pair
    taps = keys.collect_taps(pmodel, kx[:2])
    jtaps = jax_keys.collect_taps(jmodel, v, jnp.asarray(kx[:2]))
    assert sorted(n.replace(".", "/") for n in taps) == sorted(jtaps)
    tap = keys.get_intermediate_activation(pmodel, kx[:2],
                                           "layer4_0.convbnrelu_1")
    assert tap.shape == (2, 256, 4, 4)  # layer4 takes layer3's 4x4 maps
    with pytest.raises(KeyError):
        keys.get_intermediate_activation(pmodel, kx[:2], "layer9_0")


# ---------------------------------------------------------- checkpoints

def _v2_state(seed=0, lr=0.01):
    model = build_model("resnet9", 10, passport_kwargs=_v2_kwargs("random"),
                        private=True, input_size=SIDE, seed=seed,
                        device="cpu")
    return TrainState.create(model, lr)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, SIDE, SIDE, 3), np.uint8),
             "label": rng.integers(0, 10, 8)} for _ in range(n)]


def _steps(state, batches):
    step = make_train_step(state.model, True, pad=2, seed=3, device="cpu")
    for batch in batches:
        state, _ = step(state, batch)
    return state


def _same_state(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[pa]["momentum_buffer"],
                           b.optimizer.state[pb]["momentum_buffer"])


@pytest.mark.parametrize("asynchronous", [False, True])
def test_checkpoint_round_trip(tmp_path, asynchronous):
    state = _steps(_v2_state(), _batches(1))
    path = str(tmp_path / "models" / "a.ckpt")
    if asynchronous:
        ckpt = AsyncCheckpointer()
        ckpt.save(path, state)
        ckpt.flush()
    else:
        save_state(path, state)
    fresh = load_state(path, _v2_state(seed=9))
    _same_state(fresh, state)


def test_restore_opt_false_keeps_the_templates_optimizer(tmp_path):
    trained = _steps(_v2_state(), _batches(2))
    save_state(str(tmp_path / "t.ckpt"), trained)
    template = _steps(_v2_state(seed=9), _batches(1, seed=1))
    momentum = [template.optimizer.state[p]["momentum_buffer"].clone()
                for p in template.model.parameters()]
    loaded = load_state(str(tmp_path / "t.ckpt"), template, restore_opt=False)
    assert loaded.step == 1
    for p, m in zip(loaded.model.parameters(), momentum):
        assert torch.equal(loaded.optimizer.state[p]["momentum_buffer"], m)
    for k, t in trained.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], t), k


@pytest.mark.parametrize("fault", ["passport", "signature", "missing"])
def test_unmatched_entries_raise(tmp_path, fault):
    state = _v2_state()
    save_state(str(tmp_path / "c.ckpt"), state)
    data = torch.load(str(tmp_path / "c.ckpt"), weights_only=True)
    entry = {"passport": "layer4_0.convbn_2.key",
             "signature": "layer4_0.shortcut.b",
             "missing": "layer4_0.convbn_2.conv.weight"}[fault]
    del data["model"][entry]
    torch.save(data, str(tmp_path / "c.ckpt"))
    with pytest.raises(ValueError, match=entry.rsplit(".", 1)[0]):
        load_state(str(tmp_path / "c.ckpt"), _v2_state(seed=1))


def test_extra_entries_are_dropped_loudly(tmp_path, capsys):
    """A separate-stats checkpoint into a shared-stats template: the
    private BN statistics are dropped with a warning, as in JAX."""
    kw = _v2_kwargs("random")
    mark_separate_stats(kw)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        input_size=SIDE, device="cpu")
    save_state(str(tmp_path / "s.ckpt"), TrainState.create(model, 0.01))
    load_state(str(tmp_path / "s.ckpt"), _v2_state(), restore_opt=False)
    assert "WARNING: load_state dropped 6 checkpoint entries" in \
        capsys.readouterr().out


def test_resume_equals_uninterrupted_training(tmp_path):
    batches = _batches(4, seed=2)
    straight = _steps(_v2_state(), batches)
    first = _steps(_v2_state(), batches[:2])
    save_state(str(tmp_path / "r.ckpt"), first)
    resumed = load_state(str(tmp_path / "r.ckpt"), _v2_state(seed=5))
    assert resumed.step == 2
    _same_state(_steps(resumed, batches[2:]), straight)


# ---------------------------------------------------------- experiment

def test_derive_scheme_matches_jax():
    flags = ("train_passport", "train_private", "train_backdoor")
    for bits in range(8):
        args = {f: bool(bits >> i & 1) for i, f in enumerate(flags)}
        assert experiment.derive_scheme(args) == jax_derive_scheme(args)


def base_args(tmp_path, **over):
    """tests/test_experiment.py's arguments, for a ResNet9."""
    args = vars(train_v1.build_parser().parse_args([]))
    args.update({"arch": "resnet9", "dataset": "synthetic", "batch_size": 32,
                 "epochs": 1, "lr_config": "lr_configs/finetune.json",
                 "passport_config": str(CONFIGS / "resnet9_passport.json"),
                 "logdir": str(tmp_path / "logs"), "synthetic_train": 64,
                 "synthetic_test": 32})
    args.update(over)
    return args


def test_expid_increments(tmp_path):
    a1 = experiment.ClassificationExperiment(base_args(tmp_path), "cpu")
    a2 = experiment.ClassificationExperiment(base_args(tmp_path), "cpu")
    assert a1.logdir.endswith("/1") and a2.logdir.endswith("/2")
    assert a1.logdir.startswith(str(tmp_path / "logs" / "resnet9_synthetic_v0"))


def test_wm_freeze_warning():
    warn = experiment.wm_freeze_warning
    assert warn(3, {"wm_total_acc": 10.0}, {"wm_total_acc": 90.0}) \
        .startswith("WARNING: best.ckpt froze at epoch 3")
    assert warn(3, {"wm_total_acc": 80.0}, {"wm_total_acc": 90.0}) is None
    assert warn(3, {"wm_acc": 5.0}, {"wm_acc": 50.0}) is not None
    assert warn(3, {}, {"valid_acc": 50.0}) is None


def test_nan_guard_halts_with_actionable_message(tmp_path, monkeypatch):
    exp = experiment.ClassificationExperiment(base_args(tmp_path), "cpu")
    with pytest.raises(experiment.TrainingDiverged, match="lr"):
        exp._check_finite(3, {"loss": float("nan"), "acc": 1.0})
    exp._check_finite(3, {"loss": 0.5, "acc": 1.0})
    monkeypatch.setattr(exp, "_train_epoch", lambda ep: {"loss": float("inf")})
    with pytest.raises(experiment.TrainingDiverged):
        exp.training()


@pytest.mark.parametrize("flag", ["multihost", "download", "imagenet1000",
                                  "caltech-101"])
def test_unported_paths_raise_naming_their_item(tmp_path, request, flag):
    """--download, --multihost, the ImageNet and Caltech datasets, which
    raised here until they were ported, now build the experiment on the
    CPU: --download fetches CIFAR-10 from its (``file://``) URL into an
    empty data root; --multihost without a process group of several ranks
    is the single-process experiment (no mesh); the datasets from a tiny
    folder."""
    from test_torch_port_data import write_class_folders, write_imagenet

    if flag == "download":
        request.getfixturevalue("published")
        exp = experiment.ClassificationExperiment(
            base_args(tmp_path, download=True, dataset="cifar10",
                      data_root=str(tmp_path / "data"), batch_size=4),
            "cpu")
        assert os.path.isdir(tmp_path / "data" / "cifar10"
                             / "cifar-10-batches-py")
        batch = next(iter(exp._batches()))
        assert batch["image"].shape == (4, 32, 32, 3)
        return
    if flag == "multihost":
        exp = experiment.ClassificationExperiment(
            base_args(tmp_path, multihost=True), "cpu")
        assert exp.mesh is None and exp.n_shards == 1 and exp.writer
        return
    if flag == "imagenet1000":
        write_imagenet(tmp_path / "data")
        over = {"arch": "alexnet", "epoch_scan": True,
                "device_augment": True}
    else:
        write_class_folders(str(tmp_path / "data" / flag), classes=3)
        over = {}
    exp = experiment.ClassificationExperiment(
        base_args(tmp_path, dataset=flag, data_root=str(tmp_path / "data"),
                  batch_size=2, workers=2, **over), "cpu")
    assert exp.num_classes == {"imagenet1000": 1000, "caltech-101": 101}[flag]
    assert exp.epoch_fn is None  # ImageNet streams: --epoch-scan ignored
    batch = next(iter(exp._batches()))
    size = 224 if flag == "imagenet1000" else 32
    assert batch["image"].shape == (2, size, size, 3)
    assert batch["image"].dtype == (np.uint8 if over else np.float32)


def test_experiment_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.ClassificationExperiment(base_args(tmp_path))


# ---------------------------------------------------------------- CLIs

def _options(parser):
    return {tuple(a.option_strings): (a.dest, a.default,
                                      tuple(a.choices or ()), a.type, a.nargs,
                                      type(a).__name__)
            for a in parser._actions}


def test_parser_matches_the_jax_cli():
    assert _options(train_v1.build_parser()) == \
        _options(jax_train_v1.build_parser())


def test_train_v23_turns_train_private_on(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(train_v1, "run",
                        lambda args, device: seen.update(args, device=device))
    monkeypatch.setattr(train_v23, "run",
                        lambda args, device: seen.update(args, device=device))
    train_v23.main(["--epochs", "1"], device="cpu", synthetic_train=8)
    assert seen["train_private"] and seen["epochs"] == 1
    assert seen["synthetic_train"] == 8 and seen["device"] == "cpu"
    train_v1.main([], device="cpu")
    assert not seen["train_private"]
