"""The port's attack CLIs on the CPU: each of the six runs in-process on a
one-epoch checkpoint of the port and writes the CSV the repository's root
script writes (file name and columns, taken from the same root script run on
the JAX package), parses the same flags, and raises for what is not ported.
"""

import argparse
import csv
import importlib
import os
import sys

import pytest
import torch

import deepipr_tpu.attacks.cli_common as jax_cli_common

from deepipr_tpu_torch.attacks.cli_common import load_attacked_model
from deepipr_tpu_torch.cli import (
    flip_attack,
    passport_attack_1,
    passport_attack_2,
    passport_attack_3,
    passport_forge_attack,
    pruning_attack,
    train_v1,
    train_v23,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.checkpoint import save_state
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
    mark_separate_stats,
)

from test_torch_port_model import CONFIGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"synthetic_train": 64, "synthetic_test": 32}
CONFIG = str(CONFIGS / "resnet9_passport.json")
CLIS = {
    # name: (port module, its arguments, the log directory's kind)
    "pruning_attack": (pruning_attack, [], "pruning_attack"),
    "flip_attack": (flip_attack, [], "flipping_attack"),
    "passport_attack_1": (passport_attack_1, ["--attack-rep", "2"],
                          "passport_attack_1"),
    "passport_attack_2": (passport_attack_2,
                          ["--flipperc", "0.5", "--epochs", "1"],
                          "passport_attack_2"),
    "passport_attack_3": (passport_attack_3,
                          ["--flipperc", "0.1", "--epochs", "1"],
                          "passport_attack_3"),
    "passport_forge_attack": (passport_forge_attack,
                              ["--flippercs", "0,0.5", "--steps", "2",
                               "--refine-epochs", "1"],
                              "passport_forge_attack"),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_argv(logdir, *extra):
    return ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size",
            "32", "--epochs", "1", "--lr-config",
            os.path.join(REPO, "lr_configs", "finetune.json"),
            "--passport-config", CONFIG, "--logdir", str(logdir), *extra]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{scheme: best.ckpt} of one-epoch V1 and V2 runs of the port."""
    logdir = tmp_path_factory.mktemp("runs")
    v1 = train_v1.main(_train_argv(logdir, "--train-passport"),
                       device="cpu", **SIZES)
    v2 = train_v23.main(_train_argv(logdir), device="cpu", **SIZES)
    return {s: os.path.join(e.logdir, "models", "best.ckpt")
            for s, e in ((1, v1), (2, v2))}


def _attack_argv(scheme, loadpath, *extra):
    return ["--arch", "resnet9", "--dataset", "synthetic", "--scheme",
            str(scheme), "--batch-size", "16", "--passport-config", CONFIG,
            "--loadpath", loadpath, *extra]


def _csv(directory):
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name)) as f:
        return name, next(csv.reader(f))


def _jax_csv(tmp_path, monkeypatch, name, argv):
    """The root script's CSV name and columns, from a run on the JAX package
    of a randomly initialised model (no --loadpath) on the same small
    synthetic set."""
    root = importlib.import_module(name)
    prepare = jax_cli_common.prepare_dataset
    monkeypatch.setattr(jax_cli_common, "prepare_dataset",
                        lambda args: prepare({**args, **SIZES}))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.chdir(tmp_path)
    root.main()
    return _csv(os.path.join(tmp_path, "logs", CLIS[name][2], "run"))


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_writes_the_root_scripts_csv(name, checkpoints, tmp_path,
                                         monkeypatch):
    module, extra, kind = CLIS[name]
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    out = module.main(_attack_argv(2, checkpoints[2], *extra), device="cpu",
                      **SIZES)
    rows = out[0] if name == "passport_forge_attack" else out
    assert rows and all(r["backend"] == "cpu" for r in rows)
    logdir = jax_cli_common.attack_logdir(kind, checkpoints[2])
    got = _csv(os.path.join(port_dir, logdir))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    want = _jax_csv(jax_dir, monkeypatch, name, _attack_argv(2, "", *extra))
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_flip_cli_on_a_v1_checkpoint(checkpoints, tmp_path, monkeypatch):
    """Scheme 1: the model is rebuilt with learnable affines to hold the
    flipped values; detection stays at its 0 % value."""
    monkeypatch.chdir(tmp_path)
    rows = flip_attack.main(_attack_argv(1, checkpoints[1]), device="cpu",
                            **SIZES)
    assert [r["perc"] for r in rows] == list(range(0, 101, 10))
    assert len({r["detect_mean"] for r in rows}) == 1


class _Parsed(Exception):
    pass


def _root_parser(name, monkeypatch):
    """The parser the root script builds, caught at its parse_args()."""
    def catch(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        importlib.import_module(name).main()
    monkeypatch.undo()
    return caught.value.args[0]


def _flags(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.nargs,
             a.const, a.required, type(a).__name__)
            for a in parser._actions]


@pytest.mark.parametrize("name", sorted(CLIS))
def test_parser_matches_the_root_script(name, monkeypatch):
    want = _root_parser(name, monkeypatch)
    got = CLIS[name][0].build_parser()
    assert _flags(got) == _flags(want)
    assert got.description == want.description


def test_unported_inputs_raise(checkpoints, tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        pruning_attack.main(_attack_argv(2, str(tmp_path / "ref.pth")),
                            device="cpu", **SIZES)
    # the default --arch is alexnet, which a resnet9 checkpoint does not fit
    with pytest.raises(ValueError, match="features_"):
        pruning_attack.main(
            ["--loadpath", checkpoints[2], "--dataset", "synthetic"],
            device="cpu", **SIZES)
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pruning_attack.main(_attack_argv(2, checkpoints[2]), **SIZES)


def test_separate_stats_found_in_the_checkpoint(tmp_path):
    """A checkpoint with per-branch BN statistics is loaded with them,
    without --separate-stats, read from its state-dict names."""
    kw, _ = construct_passport_kwargs(load_passport_config(CONFIG), "bn",
                                      "shuffle", 0.1)
    mark_separate_stats(kw)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        device="cpu")
    path = str(tmp_path / "sep.ckpt")
    save_state(path, TrainState.create(model, 0.01))
    args = argparse.Namespace(**vars(pruning_attack.build_parser().parse_args(
        _attack_argv(2, path))))
    loaded, *_ = load_attacked_model(args, device="cpu")
    assert any(".bn_private." in k for k in loaded.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
