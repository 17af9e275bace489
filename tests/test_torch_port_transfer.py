"""Transfer learning and remat="full" of the port against the JAX package.

TL: a JAX ``ClassificationExperiment`` and the port's are built from the
same arguments (``--transfer-learning``, ``tl_dataset="synthetic"``); the
JAX model's variables, BN statistics redrawn with numpy, go into both, and
each package's ``transfer_learning`` runs one epoch. The clone's initial
weights, rtal's fresh last classifier among them, are the JAX package's
(``init=``, W7); the host draws (shuffle, flips; TL drops the random crop)
are the JAX package's NumPy draws by construction. For V1, V2 and V3,
rtal and ftal, on ResNet9 and AlexNet:

- the per-epoch rows: the same columns; survival (``old_wm_passport_*``)
  and the trigger-set accuracies (``backdoor_acc_*``) exact; every other
  metric at METRIC_TOL (tests/test_torch_port_attacks.py);
- the fine-tuned clone's update, each parameter's and BN statistic's
  difference from JAX's within TL_UPDATE_TOL of its norm;
- ``exp.model`` bit for bit the trained model afterwards.

remat="full": the plain and split train steps give updates and BN running
statistics equal to remat="none", bit for bit (a second EMA in the
recomputed forward would move the buffers).
"""

import copy
import csv
import functools
import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepipr_tpu.models.registry import build_model as jax_build_model
from deepipr_tpu.train import experiment as jax_experiment
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train import steps as jax_steps
from deepipr_tpu.train import transfer as jax_transfer

from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.interop.jax_params import (
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.train import experiment, transfer
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_train_step
from deepipr_tpu_torch.utils.checkpoint import save_state
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from test_torch_port_attacks import METRIC_TOL
from test_torch_port_model import CONFIGS, numpy_variables
from test_torch_port_train import MOMENTUM_NORM_TOL

# The clone's update, port against JAX, each parameter's difference over
# its update's norm: the clone trains as the train steps do (train-mode BN,
# ReLU), whose gradients tests/test_torch_port_train.py holds within
# MOMENTUM_NORM_TOL of their norm (a pre-ReLU value within float32 noise of
# zero lands on opposite sides in XLA and ATen and moves whole gradients).
# Measured worst over the twelve cases: 9.5e-3 (a ResNet9 BN bias); the
# metrics' worst 3.6e-6 relative, within METRIC_TOL.
TL_UPDATE_TOL = MOMENTUM_NORM_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"synthetic_train": 32, "synthetic_test": 16}
SCHEMES = {1: {"train_passport": True}, 2: {"train_private": True},
           3: {"train_private": True, "train_backdoor": True}}
PASSPORT_CONFIG = {"resnet9": "resnet9_passport.json",
                   "alexnet": "alexnet_passport.json"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the module, as the other port test files:
    the tier-1 run puts several pytest workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRIGGERS = 8  # of the repository's trigger set, for V3's retest


@pytest.fixture(scope="module")
def triggers(tmp_path_factory):
    """The first TRIGGERS images of data/trigger_set in the WatermarkNN
    layout (pics/ beside labels-cifar.txt): V3's retest at a tenth of the
    cost."""
    src = os.path.join(REPO, "data", "trigger_set")
    pics = tmp_path_factory.mktemp("triggers") / "pics"
    pics.mkdir()
    for name in sorted(os.listdir(os.path.join(src, "pics")))[:TRIGGERS]:
        shutil.copy(os.path.join(src, "pics", name), pics / name)
    with open(os.path.join(src, "labels-cifar.txt")) as f:
        labels = f.read().split()[:TRIGGERS]
    (pics.parent / "labels-cifar.txt").write_text("\n".join(labels) + "\n")
    return str(pics)


def tl_args(logdir, arch, scheme, tl_scheme, trigger_path):
    """The train CLI's defaults with a small TL run on the synthetic set."""
    args = vars(train_v1.build_parser().parse_args([]))
    args.update({"arch": arch, "dataset": "synthetic", "batch_size": 16,
                 "epochs": 1, "key_type": "random",
                 "lr_config": os.path.join(REPO, "lr_configs",
                                           "finetune.json"),
                 "passport_config": str(CONFIGS / PASSPORT_CONFIG[arch]),
                 "trigger_path": trigger_path,
                 "logdir": str(logdir), "transfer_learning": True,
                 "tl_dataset": "synthetic", "tl_scheme": tl_scheme,
                 **SCHEMES[scheme], **SIZES})
    return args


# The JAX package's steps and optimizer, made once per definition: a flax
# module's repr names every field, so equal reprs are equal models and
# their jitted steps the same functions; the optimizer is static in the
# state, so an equal one built anew would recompile the steps
# (transfer_learning and the experiment otherwise compile them anew for
# every run)
_JAX_MADE = {}


def _cached(make):
    def cached(first, *args, **kwargs):
        key = (make.__name__, repr(first), args,
               tuple(sorted(kwargs.items())))
        if key not in _JAX_MADE:
            _JAX_MADE[key] = make(first, *args, **kwargs)
        return _JAX_MADE[key]
    return cached


def _equal_experiments(logdir, arch, scheme, trigger_path):
    """(JAX experiment, port experiment) on equal weights. Both packages'
    ``transfer_learning`` leave their experiment as it was and read the TL
    scheme from ``exp.tl_scheme``, so one pair serves rtal and ftal."""
    args = tl_args(logdir, arch, scheme, "rtal", trigger_path)
    jexp = jax_experiment.ClassificationExperiment({**args,
                                                    "use_mesh": False})
    v = numpy_variables(jexp.state.model_variables(), seed=scheme)
    jexp.state = jexp.state.replace(**{k: jax.tree.map(jnp.asarray, t)
                                       for k, t in v.items()})
    if jexp.private:
        jexp.dual_eval_step = _cached(jax_steps.make_dual_eval_step)(
            jexp.model)
    pexp = experiment.ClassificationExperiment(args, "cpu")
    load_jax_variables(pexp.model, v)
    return jexp, pexp


@functools.lru_cache(maxsize=None)
def _jax_clone_init(arch, seed):
    """The clone's initial variables as JAX's transfer_learning draws them
    (transfer.py:79-85), in the port's names."""
    tl_model = jax_build_model(arch, 10, "bn")
    tl_vars = tl_model.init({"params": jax.random.key(seed + 100)},
                            jnp.zeros((1, 32, 32, 3)), train=True)
    return jax_state_dict(jax.tree.map(np.asarray, dict(tl_vars)))


def _jax_last(logdir):
    """The JAX run's tl-last.ckpt parameters and statistics, port names."""
    with open(os.path.join(logdir, "tl_1", "models", "tl-last.ckpt"),
              "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    tree = {k: raw[k] for k in ("params", "batch_stats") if raw.get(k)}
    return jax_state_dict(tree)


def _header(logdir):
    with open(os.path.join(logdir, "tl_1", "history.csv")) as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, triggers):
    """run(arch, scheme, tl_scheme) -> (JAX rows, JAX history.csv header,
    JAX tl-last.ckpt, the port experiment on equal weights before TL, its
    ``tl_scheme`` set): the JAX package's transfer learning, run once per
    case, on one pair of experiments per (arch, scheme)."""
    runs, pairs = {}, {}

    def run(arch, scheme, tl_scheme):
        case = (arch, scheme, tl_scheme)
        if case not in runs:
            if (arch, scheme) not in pairs:
                pairs[arch, scheme] = _equal_experiments(
                    tmp_path_factory.mktemp("tl"), arch, scheme, triggers)
            jexp, pexp = pairs[arch, scheme]
            jexp.tl_scheme = tl_scheme
            patch = pytest.MonkeyPatch()
            for name, make in (("make_train_step",
                                jax_steps.make_train_step),
                               ("make_eval_step", jax_steps.make_eval_step),
                               ("sgd_optimizer", jax_sgd)):
                patch.setattr(jax_transfer, name, _cached(make))
            try:
                rows = jax_transfer.transfer_learning(jexp)
            finally:
                patch.undo()
            runs[case] = (rows, _header(jexp.logdir), _jax_last(jexp.logdir),
                          pexp)
        runs[case][3].tl_scheme = tl_scheme
        return runs[case]

    return run


CASES = [(arch, scheme, tl) for arch in ("resnet9", "alexnet")
         for scheme in (1, 2, 3) for tl in ("rtal", "ftal")]


@pytest.mark.parametrize("arch,scheme,tl_scheme", CASES)
def test_transfer_learning_matches_jax(jax_runs, monkeypatch, arch, scheme,
                                       tl_scheme):
    want, _, jax_last, pexp = jax_runs(arch, scheme, tl_scheme)
    trained = copy.deepcopy(pexp.model.state_dict())
    seen = {}
    real_step = transfer.make_train_step

    def spy(model, *a, **k):  # the clone before its first step
        seen["model"] = model
        seen["start"] = copy.deepcopy(model.state_dict())
        return real_step(model, *a, **k)

    monkeypatch.setattr(transfer, "make_train_step", spy)
    init = {k: torch.from_numpy(v)
            for k, v in _jax_clone_init(arch, pexp.seed).items()}
    got = transfer.transfer_learning(pexp, init=init)

    assert len(got) == len(want) == 1
    (g,), (w,) = got, want
    assert sorted(g) == sorted(w)
    survival = [k for k in w if k.startswith("old_wm_passport_")]
    assert len(survival) == 3  # the three passport layers of each config
    backdoor = [k for k in w if k.startswith("backdoor_")]
    assert bool(backdoor) == (scheme == 3)
    exact = survival + [k for k in backdoor if "acc" in k] + ["epoch"]
    for k in exact:
        assert g[k] == w[k], k
    for k in set(w) - set(exact):
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **METRIC_TOL)

    final = seen["model"].state_dict()
    assert sorted(jax_last) == sorted(final)
    for k, start in seen["start"].items():
        update = (final[k] - start).norm()
        diff = (final[k] - torch.from_numpy(jax_last[k])).norm()
        assert diff <= TL_UPDATE_TOL * max(update, 1e-12), k

    # the experiment's own model is the trained one, bit for bit
    for k, v in pexp.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    for name in ("history.csv", "models/tl-best.ckpt",
                 "models/tl-last.ckpt"):
        assert os.path.exists(os.path.join(pexp.logdir, "tl_1", name))


@pytest.mark.parametrize("scheme", [1, 3])
def test_transfer_learning_cli_writes_the_root_scripts_columns(
        tmp_path, jax_runs, triggers, scheme):
    """``--transfer-learning`` through the port's train CLI (train_v1 for
    V1, train_v23 for V3) from a port checkpoint writes tl_1/history.csv
    with the columns that the root scripts' ``transfer_learning`` writes on
    the JAX package, and ignores --device-augment and --epoch-scan as they
    do."""
    args = tl_args(tmp_path, "resnet9", scheme, "rtal", triggers)
    model = build_model("resnet9", 10, passport_kwargs=construct_passport_kwargs(
        load_passport_config(args["passport_config"]), "bn", "random",
        0.1)[0], private=scheme != 1, device="cpu")
    ckpt = str(tmp_path / "attacked.ckpt")
    save_state(ckpt, TrainState.create(model, 0.01))
    argv = ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size",
            "16", "--epochs", "1", "--key-type", "random", "--lr-config",
            args["lr_config"], "--passport-config", args["passport_config"],
            "--trigger-path", args["trigger_path"], "--tl-dataset",
            "synthetic", "--transfer-learning", "--device-augment",
            "--epoch-scan", "--pretrained-path", ckpt, "--logdir",
            str(tmp_path / "logs")]
    if scheme == 1:
        exp = train_v1.main(argv + ["--train-passport"], device="cpu",
                            **SIZES)
    else:
        exp = train_v23.main(argv + ["--train-backdoor"], device="cpu",
                             **SIZES)
    assert not exp.device_augment and not exp.epoch_scan
    for k, v in model.state_dict().items():  # the checkpoint was loaded
        assert torch.equal(exp.model.state_dict()[k], v), k
    assert _header(exp.logdir) == jax_runs("resnet9", scheme, "rtal")[1]


# ------------------------------------------------------------------ remat

@pytest.mark.parametrize("arch,private,split", [
    ("resnet9", True, True), ("resnet9", True, False),
    ("resnet9", False, False), ("alexnet", True, True)])
def test_remat_full_equals_remat_none(arch, private, split):
    kw, _ = construct_passport_kwargs(
        load_passport_config(str(CONFIGS / PASSPORT_CONFIG[arch])), "bn",
        "random", 0.1)
    rng = np.random.default_rng(3)
    batches = [{"image": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 8)} for _ in range(2)]
    runs = {}
    for remat in ("none", "full"):
        model = build_model(arch, 10, passport_kwargs=kw, private=private,
                            input_size=16, seed=1, device="cpu")
        state = TrainState.create(model, 0.01)
        step = make_train_step(model, private, split_branches=split,
                               remat=remat, device="cpu")
        metrics = [step(state, b)[1] for b in batches]
        runs[remat] = (model.state_dict(), metrics)
    (none, m_none), (full, m_full) = runs["none"], runs["full"]
    for k, v in none.items():
        assert torch.equal(full[k], v), k
    for a, b in zip(m_none, m_full):
        assert {k: v.item() for k, v in a.items()} == \
            {k: v.item() for k, v in b.items()}
