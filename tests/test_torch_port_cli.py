"""The port's training entry point on the CPU: one epoch of each scheme
through ``cli.train_v1.main`` / ``cli.train_v23.main``, with JAX's logdir
layout and the ``history.csv`` columns of the same JAX run; a V2 run from a
scheme-0 run's last.ckpt (pretrained-derived keys) in bf16 on the
device-resident epoch, then ``--eval`` of it, and ``--resume``.
"""

import csv
import json
import os

import pytest
import torch

from deepipr_tpu.train.experiment import ClassificationExperiment as JaxExp

from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.keys import sample_candidates, setup_passports

from test_torch_port_model import CONFIGS

SIZES = {"synthetic_train": 64, "synthetic_test": 32}
SCHEMES = {
    # scheme: (main, flags, JAX's logdir name)
    0: (train_v1, [], "resnet9_synthetic_v0"),
    1: (train_v1, ["--train-passport"], "resnet9_synthetic_v1"),
    2: (train_v23, [], "resnet9_synthetic_v2"),
    3: (train_v23, ["--train-backdoor"], "resnet9_synthetic_v3"),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test: the tier-1 run puts several pytest
    workers on the same cores, where bf16 CPU kernels spinning on eight
    threads each slowed one test from seconds to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(tmp_path, *extra):
    return ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size",
            "32", "--epochs", "1", "--lr-config", "lr_configs/finetune.json",
            "--passport-config", str(CONFIGS / "resnet9_passport.json"),
            "--logdir", str(tmp_path / "logs"), *extra]


def _columns(logdir):
    with open(os.path.join(logdir, "history.csv")) as f:
        return next(csv.reader(f))


def _jax_columns(tmp_path, main, flags):
    """The history.csv header of the same run through the JAX package (one
    device, as the port runs)."""
    args = vars(main.build_parser().parse_args(
        _argv(tmp_path / "jax", *flags)))
    if main is train_v23:
        args["train_private"] = True
    exp = JaxExp({**args, **SIZES, "use_mesh": False})
    exp.training()
    return _columns(exp.logdir)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_each_scheme_runs_one_epoch_with_jax_layout(tmp_path, scheme):
    main, flags, dirname = SCHEMES[scheme]
    exp = main.main(_argv(tmp_path, *flags), device="cpu", **SIZES)
    d = os.path.join(str(tmp_path / "logs"), dirname, "1")
    assert exp.logdir == d
    for name in ("config.json", "history.csv", "models/best.ckpt",
                 "models/last.ckpt"):
        assert os.path.exists(os.path.join(d, name)), name
    cfg = json.load(open(os.path.join(d, "config.json")))
    assert cfg["dataset"] == "synthetic" and cfg["backend"] == "cpu"
    assert _columns(d) == _jax_columns(tmp_path, main, flags)


def test_v2_from_a_pretrained_checkpoint_in_bf16(tmp_path):
    """scheme 0 -> V2 with shuffle keys derived from its last.ckpt, bf16,
    --epoch-scan --pallas-input; then --eval of that run and --resume from
    its last.ckpt."""
    run0 = train_v1.main(_argv(tmp_path), device="cpu", **SIZES)
    ckpt = os.path.join(run0.logdir, "models", "last.ckpt")
    v2 = _argv(tmp_path, "--pretrained-path", ckpt, "--bf16",
               "--epoch-scan", "--pallas-input")
    run2 = train_v23.main(v2, device="cpu", **SIZES)
    assert run2.model.dtype == torch.bfloat16
    rows = list(csv.DictReader(open(os.path.join(run2.logdir,
                                                 "history.csv"))))
    assert len(rows) == 1 and "valid_total_acc" in rows[0]

    # the passports came from run 0's weights: derive them again by hand
    images = run2._passport_candidates()
    want = setup_passports(run0.model, run2.model,
                           sample_candidates(images, 20, seed=10),
                           sample_candidates(images, 20, seed=11), seed=12)
    fresh = train_v23.main(v2 + ["--epochs", "0"], device="cpu", **SIZES)
    own = passports(fresh.model)
    for name, value in want.items():
        torch.testing.assert_close(own[name], value, rtol=0, atol=0)

    evaluated = train_v23.main(v2 + ["--eval", "--exp-id", "1"],
                               device="cpu", **SIZES).evaluate_only()
    assert set(evaluated) == {"loss_public", "acc_public", "loss_private",
                              "acc_private", "total_acc"}
    last = os.path.join(run2.logdir, "models", "last.ckpt")
    resumed = train_v23.main(v2 + ["--resume", last, "--epochs", "0"],
                             device="cpu", **SIZES)
    assert resumed.state.step == run2.state.step == 2
    for k, t in run2.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], t), k


def test_the_other_flags_run(tmp_path):
    """V3 with --separate-stats, --use-trigger-as-passport, --device-augment,
    --save-interval, --ckpt-every and --profile: the checkpoints, the
    private BN statistics and the profiler's trace are where JAX puts
    them."""
    exp = train_v23.main(_argv(
        tmp_path, "--train-backdoor", "--separate-stats",
        "--use-trigger-as-passport", "--device-augment", "--save-interval",
        "1", "--ckpt-every", "2", "--profile"), device="cpu", **SIZES)
    models = sorted(os.listdir(os.path.join(exp.logdir, "models")))
    assert models == ["best.ckpt", "epoch-0.ckpt", "epoch-1.ckpt",
                      "last.ckpt"]
    assert os.path.exists(os.path.join(exp.logdir, "profile", "trace.json"))
    assert any(k.endswith("bn_private.running_mean")
               for k in exp.model.state_dict())
    assert "wm_total_acc" in _columns(exp.logdir)
