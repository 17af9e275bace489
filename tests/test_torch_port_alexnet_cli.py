"""The port's entry points on AlexNet, the CLIs' default architecture, on the
CPU: ``cli.train_v1`` with no ``--arch`` and the first recipe of
training.sh (scheme 0, then V1 with shuffle keys derived from its
last.ckpt on the device-resident epoch with K1's plain version), V2 and V3
through ``cli.train_v23``, each with the ``history.csv`` columns of the same
JAX run; then the six attack CLIs at ``--arch alexnet`` on those V1 and V2
checkpoints, with the root scripts' CSV names and columns, and the pruning
and flip CLIs' rows against the root scripts' on equal weights (detection
sign for sign).
"""

import csv
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepipr_tpu.attacks.cli_common as jax_cli_common
from deepipr_tpu.models import alexnet as jax_alexnet
from deepipr_tpu.train.experiment import ClassificationExperiment as JaxExp
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.utils.checkpoint import save_state as jax_save_state
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.interop.jax_params import load_jax_variables
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.serve import passports, verify_ownership
from deepipr_tpu_torch.train.keys import sample_candidates, setup_passports
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.checkpoint import load_state, save_state

from test_torch_port_attack_cli import CLIS
from test_torch_port_model import CONFIGS, RNGS, numpy_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"synthetic_train": 64, "synthetic_test": 32}
CONFIG = str(CONFIGS / "alexnet_passport.json")
ONE_IMAGE = 100.0 / SIZES["synthetic_test"]  # one validation image, in %


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread, as the other port test files: the tier-1 run
    puts several pytest workers on the same cores. Module-scoped, so that
    it is in place before the module's other fixtures train models."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_argv(logdir, *extra):
    """The CLIs' flags for a short synthetic run; no --arch: AlexNet is
    the default."""
    return ["--dataset", "synthetic", "--batch-size", "32", "--epochs", "1",
            "--lr-config", os.path.join(REPO, "lr_configs", "finetune.json"),
            "--passport-config", CONFIG, "--logdir", str(logdir), *extra]


def _columns(logdir):
    with open(os.path.join(logdir, "history.csv")) as f:
        return next(csv.reader(f))


# scheme: (port entry point, flags after scheme 0's last.ckpt, the JAX run's
# flags); training.sh's V1 recipe with --epoch-scan --pallas-input
SCHEMES = {
    0: (train_v1, [], []),
    1: (train_v1, ["--train-passport", "--sign-loss", "0.1", "--key-type",
                   "shuffle", "--epoch-scan", "--pallas-input"],
        ["--train-passport"]),
    2: (train_v23, ["--key-type", "shuffle"], []),
    3: (train_v23, ["--key-type", "shuffle", "--train-backdoor"],
        ["--train-backdoor"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{scheme: the port's experiment}: scheme 0 at the CLI's defaults, then
    each passport scheme with keys derived from scheme 0's last.ckpt."""
    logdir = tmp_path_factory.mktemp("runs")
    out = {0: train_v1.main(_train_argv(logdir), device="cpu", **SIZES)}
    pretrained = os.path.join(out[0].logdir, "models", "last.ckpt")
    for scheme in (1, 2, 3):
        main, flags, _ = SCHEMES[scheme]
        out[scheme] = main.main(_train_argv(
            logdir, "--pretrained-path", pretrained, *flags), device="cpu",
            **SIZES)
    return out


def _jax_columns(tmp_path, scheme):
    """The history.csv header of the same scheme's run through the JAX
    package (one device, as the port runs)."""
    main, _, flags = SCHEMES[scheme]
    args = vars(main.build_parser().parse_args(
        _train_argv(tmp_path / "jax", *flags)))
    if main is train_v23:
        args["train_private"] = True
    exp = JaxExp({**args, **SIZES, "use_mesh": False})
    exp.training()
    return _columns(exp.logdir)


def test_train_v1_defaults_to_alexnet(runs, monkeypatch, tmp_path):
    """``train_v1`` with no --arch trains AlexNet (the logdir and config say
    so); with no --passport-config either, from the repository root."""
    assert runs[0].arch == "alexnet"
    assert os.path.basename(os.path.dirname(runs[0].logdir)) == \
        "alexnet_synthetic_v0"
    assert type(runs[0].model).__name__ == "AlexNet"
    monkeypatch.chdir(REPO)
    exp = train_v1.main(["--dataset", "synthetic", "--epochs", "0",
                         "--logdir", str(tmp_path)], device="cpu", **SIZES)
    assert exp.model.classifier.in_features == 4096


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_each_scheme_writes_the_jax_runs_columns(runs, tmp_path, scheme):
    exp = runs[scheme]
    for name in ("config.json", "history.csv", "models/best.ckpt",
                 "models/last.ckpt"):
        assert os.path.exists(os.path.join(exp.logdir, name)), name
    assert os.path.basename(os.path.dirname(exp.logdir)) == \
        f"alexnet_synthetic_v{scheme}"
    assert _columns(exp.logdir) == _jax_columns(tmp_path, scheme)


def test_v1_recipe_takes_its_keys_from_the_pretrained_run(runs):
    """The V1 run's passports are scheme 0's taps at features_4-6, and its
    best.ckpt in a fresh model is verified by the derived scales it holds
    (the signature each layer was trained towards for one epoch)."""
    run0, run1 = runs[0], runs[1]
    images = run1._passport_candidates()
    want = setup_passports(run0.model, run1.model,
                           sample_candidates(images, 20, seed=10),
                           sample_candidates(images, 20, seed=11), seed=12)
    fresh = build_model("alexnet", 10, passport_kwargs=run1.passport_kwargs,
                        seed=123, device="cpu")
    load_state(os.path.join(run1.logdir, "models", "best.ckpt"),
               TrainState.create(fresh, 0.0), restore_opt=False)
    assert sorted(want) == sorted(passports(fresh))
    assert tuple(want["features_4.key"].shape) == (1, 192, 8, 8)
    verdict = verify_ownership(fresh, (1, 32, 32, 3), private=False,
                               device="cpu")
    assert sorted(verdict["layers"]) == ["features_4", "features_5",
                                         "features_6"]
    rows = list(csv.DictReader(open(os.path.join(run1.logdir,
                                                 "history.csv"))))
    for layer, rate in verdict["layers"].items():
        assert rate == float(rows[-1][f"s_public_{layer}"]), layer


# ------------------------------------------------------------ attacks

def _attack_argv(scheme, loadpath, *extra):
    """No --arch: the attack CLIs' default, alexnet."""
    return ["--dataset", "synthetic", "--scheme", str(scheme),
            "--batch-size", "16", "--passport-config", CONFIG, "--loadpath",
            loadpath, *extra]


def _csv_rows(directory):
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name)) as f:
        rows = list(csv.reader(f))
    return name, rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def _run_root_script(tmp_path, monkeypatch, name, argv):
    """The root script run on the JAX package in ``tmp_path``, on the same
    small synthetic set: its CSV's name, header and rows."""
    root = importlib.import_module(name)
    prepare = jax_cli_common.prepare_dataset
    monkeypatch.setattr(jax_cli_common, "prepare_dataset",
                        lambda args: prepare({**args, **SIZES}))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.chdir(tmp_path)
    root.main()
    loadpath = argv[argv.index("--loadpath") + 1]
    return _csv_rows(os.path.join(
        tmp_path, jax_cli_common.attack_logdir(CLIS[name][2], loadpath)))


def _run_port_cli(tmp_path, monkeypatch, name, scheme, loadpath, extra):
    """The port's CLI in-process in ``tmp_path``: its CSV's name, header
    and rows."""
    module, _, kind = CLIS[name]
    monkeypatch.chdir(tmp_path)
    out = module.main(_attack_argv(scheme, loadpath, *extra), device="cpu",
                      **SIZES)
    rows = out[0] if name == "passport_forge_attack" else out
    assert rows and all(r["backend"] == "cpu" for r in rows)
    return _csv_rows(os.path.join(
        tmp_path, jax_cli_common.attack_logdir(kind, loadpath)))


# (CLI, scheme): attacks 1-3 and the forge attack on V1 and V2 but the forge
# attack on V1, which both packages refuse (passport_forge_attack.py:35-36);
# the pruning and flip CLIs are held to the root scripts row by row on equal
# weights (test_detection_rows_match_the_root_script)
ATTACK_CASES = [(name, scheme) for name in sorted(CLIS) for scheme in (1, 2)
                if name not in ("pruning_attack", "flip_attack")
                and (name, scheme) != ("passport_forge_attack", 1)]


@pytest.mark.parametrize("name,scheme", ATTACK_CASES)
def test_attack_cli_writes_the_root_scripts_csv(runs, name, scheme, tmp_path,
                                                monkeypatch):
    """Each attack CLI at --arch alexnet on the V1 or V2 run's best.ckpt:
    the CSV the root script writes on the JAX package (a randomly
    initialised AlexNet, no --loadpath), by name and columns."""
    extra = CLIS[name][1]
    best = os.path.join(runs[scheme].logdir, "models", "best.ckpt")
    (tmp_path / "port").mkdir()
    got = _run_port_cli(tmp_path / "port", monkeypatch, name, scheme, best,
                        extra)
    (tmp_path / "jax").mkdir()
    want = _run_root_script(tmp_path / "jax", monkeypatch, name,
                            _attack_argv(scheme, "", *extra))
    assert got[0] == want[0] and got[0].startswith(f"alexnet-{scheme}-")
    assert got[1] == want[1]


def test_forge_cli_refuses_v1_as_the_root_script_does(runs, tmp_path,
                                                     monkeypatch):
    best = os.path.join(runs[1].logdir, "models", "best.ckpt")
    with pytest.raises(SystemExit):
        _run_port_cli(tmp_path, monkeypatch, "passport_forge_attack", 1,
                      best, [])
    with pytest.raises(SystemExit):
        _run_root_script(tmp_path, monkeypatch, "passport_forge_attack",
                         _attack_argv(1, ""))


@pytest.fixture(scope="module")
def equal_checkpoints(tmp_path_factory):
    """{scheme: (JAX checkpoint, port checkpoint)} of one AlexNet's
    variables (flax init, BN statistics redrawn), each signature set to
    its derived scale's signs, so that detection is not at chance."""
    out = {}
    root = tmp_path_factory.mktemp("equal")
    for scheme in (1, 2):
        kw, _ = construct_passport_kwargs(load_passport_config(CONFIG), "bn",
                                          "shuffle", 0.1)
        private = scheme == 2
        jmodel = jax_alexnet.AlexNet(num_classes=10, passport_kwargs=kw,
                                     private=private)
        v = numpy_variables(jmodel.init(RNGS, jnp.zeros((1, 32, 32, 3)),
                                        train=True), seed=scheme)
        pmodel = build_model("alexnet", 10, passport_kwargs=kw,
                             private=private, device="cpu")
        load_jax_variables(pmodel, v)
        for path, aux in derived_affines(pmodel, (1, 32, 32, 3),
                                         private).items():
            signs = np.where(aux["scale"].numpy() >= 0, 1.0, -1.0)
            # flip a few bits so the rates are not all 1.0
            signs[: 7 * int(path[-1])] *= -1
            v["signature"][path]["b"] = signs.astype(np.float32)
        load_jax_variables(pmodel, v)
        jpath = str(root / f"jax_v{scheme}.ckpt")
        jax_save_state(jpath, JaxTrainState.create(
            jax.tree.map(jnp.asarray, v), jax_sgd(0.01)))
        ppath = str(root / f"port_v{scheme}.ckpt")
        save_state(ppath, TrainState.create(pmodel, 0.01))
        out[scheme] = (jpath, ppath)
    return out


DETECTION_CASES = {"pruning": ("pruning_attack", []),
                   "flip": ("flip_attack", []),
                   "flip_fidxs": ("flip_attack", ["--fidxs", "4,6"])}


@pytest.mark.parametrize("scheme", [1, 2])
@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_detection_rows_match_the_root_script(equal_checkpoints, case,
                                              scheme, tmp_path, monkeypatch):
    """The pruning and flip CLIs (flip also with --fidxs) on one set of
    weights in either package's checkpoint: the root script's CSV name and
    columns, and every row's detection rates equal (sign for sign, and
    the same f32: passport/codec.py::bit_accuracy multiplies by the
    reciprocal of the 384 or 256 channels as XLA does), accuracy within one
    validation image, loss at rtol 1e-3 (the logits' LOGITS_TOL)."""
    name, extra = DETECTION_CASES[case]
    jpath, ppath = equal_checkpoints[scheme]
    (tmp_path / "port").mkdir()
    csv_name, header, rows = _run_port_cli(tmp_path / "port", monkeypatch,
                                           name, scheme, ppath, extra)
    (tmp_path / "jax").mkdir()
    jcsv_name, jheader, jrows = _run_root_script(
        tmp_path / "jax", monkeypatch, name, _attack_argv(scheme, jpath,
                                                          *extra))
    assert csv_name == jcsv_name and csv_name.startswith(f"alexnet-{scheme}-")
    assert header == jheader and len(rows) == len(jrows) == 11
    detect = [k for k in header if k.startswith("detect_")]
    assert detect
    for row, jrow in zip(rows, jrows):
        for k in ["perc", *detect] + (["similarity"] if "flip" in name
                                       else []):
            assert float(row[k]) == float(jrow[k]), (row["perc"], k)
        assert abs(float(row["acc"]) - float(jrow["acc"])) <= ONE_IMAGE + 1e-9
        np.testing.assert_allclose(float(row["loss"]), float(jrow["loss"]),
                                   rtol=1e-3, atol=1e-4)
    assert float(rows[0]["detect_mean"]) < 1.0
