"""The robustness record's path, held to the JAX package over epochs: the
entry point for three epochs of V1 and V2, attack 2 for five epochs, the
checkpoint converter of ``tests/torch_port_record.py``, and ``--download``.

A ResNet9 (passport_configs/resnet9_passport.json) trains through
``cli.train_v1.main`` / ``cli.train_v23.main`` beside the JAX package's
``ClassificationExperiment`` with the canonical recipe's flags
(``--epoch-scan``, keys derived through a scheme-0 checkpoint,
``--separate-stats`` for V2). Both start from equal weights: JAX's
initial parameters, signatures and passports are loaded into the port
after its own key setup, whose passports must already equal JAX's. The
port takes JAX's epoch permutations and augmentation draws (W7). Every
``history.csv`` column but the two clock columns is held per epoch, and
the trained weights norm-wise.

Tolerances, set from the measured worst (in the comments) with a margin:
the per-epoch metrics of the JAX package's own tests
(``test_torch_port_attacks.py``'s METRIC_TOL) where they hold, the
updates norm-wise (a pre-ReLU value within float32 noise of zero lands on
opposite sides in XLA and ATen and moves whole gradients, so differences
grow with the steps).

``--download`` fetches only ``file://`` URLs of archives written here,
and a patched fetch stands in for the https -> http retry: nothing
reaches a network.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepipr_tpu.attacks import cli_common as jax_cli_common
from deepipr_tpu.attacks import reverse as jax_reverse
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.models.registry import build_model as jax_build_model
from deepipr_tpu.train.experiment import ClassificationExperiment as JaxExp
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.utils.checkpoint import save_state as jax_save_state
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
    mark_separate_stats,
)

from deepipr_tpu_torch.attacks import reverse
from deepipr_tpu_torch.cli import train_v1, train_v23
from deepipr_tpu_torch.data import acquire
from deepipr_tpu_torch.interop.jax_params import (
    export_jax_variables,
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train import experiment
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.checkpoint import save_model, save_state

import torch_port_record
from test_torch_port_attacks import (
    BATCH,
    JAX_PLPATHS,
    METRIC_TOL,
    PLPATHS,
    SHAPE,
    SIZE,
    _pair,
)
from test_torch_port_augment import jax_draws, port_draws
from test_torch_port_data import make_cifar_archive
from test_torch_port_model import CONFIGS, LOGITS_TOL, RNGS, numpy_variables

# two steps of 8 an epoch (XLA's CPU convolutions take seconds a step of
# 32), and the 20 validation images key setup samples its candidates from
SIZES = {"synthetic_train": 16, "synthetic_test": 20}
EPOCHS = 3
# the passports each package derives through the scheme-0 model: taps after
# up to four convolutions, float32 summation order apart (measured worst
# 2.2e-5 absolute on values up to 2.6)
KEY_TOL = dict(rtol=1e-4, atol=5e-5)
CLOCKS = ("train_time", "train_images_per_sec")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------- the entry point, 3 epochs

def _argv(tmp_path, side, *extra):
    return ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size",
            "8", "--epochs", str(EPOCHS), "--passport-config",
            str(CONFIGS / "resnet9_passport.json"), "--epoch-scan",
            "--logdir", str(tmp_path / side / "logs"), *extra]


def _scheme0_checkpoints(tmp_path):
    """One normal ResNet9's weights (the port's init, BN statistics redrawn)
    as a JAX checkpoint and a port checkpoint: the pretrained model of both
    packages' key setup."""
    pmodel = build_model("resnet9", 10, input_size=32, seed=5, device="cpu")
    v = numpy_variables(export_jax_variables(pmodel), seed=6)
    load_jax_variables(pmodel, v)
    jpath = str(tmp_path / "jax_v0.ckpt")
    jax_save_state(jpath, JaxTrainState.create(jax.tree.map(jnp.asarray, v),
                                               jax_sgd(0.0)))
    ppath = str(tmp_path / "port_v0.ckpt")
    save_state(ppath, TrainState.create(pmodel, 0.0))
    return jpath, ppath


def _history(logdir):
    with open(os.path.join(logdir, "history.csv")) as f:
        return [{k: float(v) for k, v in r.items() if k not in CLOCKS}
                for r in csv.DictReader(f)]


def _with_jax_draws(monkeypatch, start, seed=0):
    """The port's experiment on equal weights with JAX's draws: after its
    own key setup its model takes JAX's variables (its passports are
    returned for a check); its epochs take JAX's permutations and crop and
    flip draws. ``start``: JAX's variables before its first step."""
    seen = {}
    real_construct = experiment.ClassificationExperiment._construct_model
    real_make = experiment.make_epoch_train_fn

    def construct(self):
        real_construct(self)
        seen["passports"] = {k: v.clone() for k, v in
                             passports(self.model).items()}
        load_jax_variables(self.model, start)

    aug_root = jax.random.key(1)  # make_train_step's root for seed 0

    def draws(step, n):
        return port_draws(*jax_draws(jax.random.fold_in(aug_root, step), n,
                                     4))

    def make(model, private, batch_size, pad, **kw):
        fn = real_make(model, private, batch_size, pad,
                       **{**kw, "draws": draws})

        def epoch_fn(state, images, labels, epoch_key, *wm, **kwargs):
            ep = epoch_key - 1_000_003 * (seed + 100)
            perm = jax.random.permutation(jax.random.fold_in(
                jax.random.key(seed + 100), ep), images.shape[0])
            return fn(state, images, labels, epoch_key, *wm,
                      perm=torch.from_numpy(np.array(perm)), **kwargs)

        return epoch_fn

    monkeypatch.setattr(experiment.ClassificationExperiment,
                        "_construct_model", construct)
    monkeypatch.setattr(experiment, "make_epoch_train_fn", make)
    return seen


# The history after three epochs of two steps, from equal weights with
# JAX's draws, by kind of column. Accuracies in percent: within one image
# of their set (the 20 validation images; the epoch's two batches of 8);
# sign accuracies and detection rows: within one bit of 512; losses
# relative, growing with the steps as the updates part (measured worst,
# epochs 1 / 2 / 3: V1 1.4e-5 / 1.7e-4 / 6.4e-4, V2 4.3e-5 / 3.4e-3 /
# 1.2e-2; accuracies equal but V2's epoch-2 public train accuracy, one
# image apart; bits equal).
ONE_IMAGE = {"valid": 100.0 / SIZES["synthetic_test"],
             "train": 100.0 / SIZES["synthetic_train"]}
ONE_BIT = 1.0 / 512
LOSS_RTOL = 3e-2
# the trained parameters' distance from JAX's over JAX's update: the whole
# update, and the worst single parameter (measured: V1 0.0081 / 0.097, V2
# 0.029 / 0.19)
UPDATE_TOL = {"whole": 0.1, "each": 0.5}


def _column_tol(name):
    """(rtol, atol) of a history column."""
    if "loss" in name and "sign" not in name:
        return LOSS_RTOL, 0.0
    if name.startswith("s_") or name == "train_sign_acc":
        return 0.0, ONE_BIT
    if name == "train_sign_loss":
        return LOSS_RTOL, 0.0
    return 0.0, ONE_IMAGE[name.split("_")[0]]


@pytest.mark.parametrize("scheme", [1, 2])
def test_three_epochs_of_the_entry_point_match_jax(tmp_path, monkeypatch,
                                                   scheme):
    """V1 (``train_v1 --train-passport``) and V2 (``train_v23
    --separate-stats``), keys through a scheme-0 checkpoint, three epochs
    of ``--epoch-scan``: every history column per epoch, and each trained
    parameter's distance from JAX's over its update."""
    jckpt, pckpt = _scheme0_checkpoints(tmp_path)
    main, flags = ((train_v1, ["--train-passport"]) if scheme == 1 else
                   (train_v23, ["--separate-stats"]))
    jargs = vars(main.build_parser().parse_args(
        _argv(tmp_path, "jax", *flags, "--pretrained-path", jckpt)))
    if main is train_v23:
        jargs["train_private"] = True
    jexp = JaxExp({**jargs, **SIZES, "use_mesh": False})
    variables = jax.tree.map(np.array, jexp.state.model_variables())
    start = jax_state_dict({"params": variables["params"]})
    jexp.training()

    seen = _with_jax_draws(monkeypatch, variables)
    pexp = main.main(_argv(tmp_path, "port", *flags, "--pretrained-path",
                           pckpt), device="cpu", **SIZES)
    want_passports = jax_state_dict({"passport": jax.tree.map(
        np.asarray, jexp.state.passport)})
    for k, w in want_passports.items():
        np.testing.assert_allclose(seen["passports"][k].numpy(), w,
                                   err_msg=k, **KEY_TOL)

    got, want = _history(pexp.logdir), _history(jexp.logdir)
    assert len(got) == len(want) == EPOCHS
    assert sorted(got[0]) == sorted(want[0])
    for ep, (g, w) in enumerate(zip(got, want), 1):
        for k in w:
            rtol, atol = _column_tol(k)
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"epoch {ep} {k}")
    params = dict(pexp.model.named_parameters())
    trained = jax_state_dict(jax.tree.map(np.asarray,
                                          {"params": jexp.state.params}))
    diff = {k: params[k].detach().numpy() - w for k, w in trained.items()}
    update = {k: w - start[k] for k, w in trained.items()}
    each = max(np.linalg.norm(diff[k]) / np.linalg.norm(update[k])
               for k in trained)
    whole = np.sqrt(sum(np.sum(d ** 2) for d in diff.values())
                    / sum(np.sum(u ** 2) for u in update.values()))
    print(f"V{scheme}: update apart {whole:.3g} whole, {each:.3g} worst")
    assert whole <= UPDATE_TOL["whole"] and each <= UPDATE_TOL["each"]


# ------------------------------------------------------- attack 2, 5 epochs


def test_five_epochs_of_reverse_attack_match_jax():
    """Attack 2 on equal weights: the attacker's GroupNorm model, half the
    scale signs flipped, five epochs of affine-only SGD with momentum 0.9
    and weight decay 5e-4 over two batches, row by row: the losses at
    METRIC_TOL (measured worst 2.1e-7 relative), the accuracies within one
    image of eight (measured equal)."""
    jmodel, state, pmodel = _pair()
    rng = np.random.default_rng(21)
    batches = [{"image": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(
                    np.float32),
                "label": rng.integers(0, 10, BATCH).astype(np.int32)}
               for _ in range(2)]
    jrows = jax_reverse.reverse_attack(
        jmodel, state, jax_resnet.ResNet9(num_classes=10, norm_type="gn"),
        batches, batches, SHAPE, True, JAX_PLPATHS, flipperc=0.5, epochs=5,
        seed=0)
    rows = reverse.reverse_attack(
        pmodel, build_model("resnet9", 10, norm_type="gn", input_size=SIZE,
                            device="cpu"),
        batches, batches, SHAPE, True, PLPATHS, flipperc=0.5, epochs=5,
        seed=0)
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    for r, j in zip(rows, jrows):
        assert r["epoch"] == j["epoch"]
        assert abs(r["valid_acc"] - j["valid_acc"]) <= 100.0 / (2 * BATCH)
        for k in j:
            if k not in ("epoch", "valid_acc"):
                np.testing.assert_allclose(r[k], j[k], **METRIC_TOL,
                                           err_msg=f"epoch {j['epoch']} {k}")


# ------------------------------------------------------------ the converter

def test_converted_v2_checkpoint_loads_in_the_jax_attack_cli(tmp_path):
    """A port V2 ``--separate-stats`` ResNet9 checkpoint through
    ``torch_port_record.port_to_jax_checkpoint`` into the unchanged
    ``deepipr_tpu/attacks/cli_common.py::load_attacked_model``: both
    branches' logits as the port's, every passport, signature and private
    BN statistic carried; a checkpoint of another build is refused."""
    cfg = str(CONFIGS / "resnet9_passport.json")
    kw, _ = construct_passport_kwargs(load_passport_config(cfg), "bn",
                                      "shuffle", 0.1)
    mark_separate_stats(kw)
    jmodel = jax_build_model("resnet9", 10, "bn", passport_kwargs=kw,
                             private=True)
    v = numpy_variables(jmodel.init(RNGS, jnp.zeros((1, 32, 32, 3)),
                                    train=True), seed=7)
    pmodel = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                         input_size=32, device="cpu")
    load_jax_variables(pmodel, v)
    assert any(".bn_private." in k for k in pmodel.state_dict())
    src, dst = str(tmp_path / "best.ckpt"), str(tmp_path / "jax.ckpt")
    save_model(src, pmodel)
    torch_port_record.port_to_jax_checkpoint(src, dst, 2, arch="resnet9",
                                             passport_config=cfg)

    args = argparse.Namespace(arch="resnet9", passport_config=cfg,
                              norm_type="bn", loadpath=dst,
                              separate_stats=False, scheme=2,
                              dataset="synthetic", lr=0.01)
    model, state, *_ = jax_cli_common.load_attacked_model(args)
    loaded = jax_state_dict(jax.tree.map(np.asarray,
                                         state.model_variables()))
    for k, t in pmodel.state_dict().items():
        np.testing.assert_array_equal(loaded[k], t.numpy(), err_msg=k)
    x = np.random.default_rng(8).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    pmodel.eval()
    with torch.no_grad():
        for ind in (0, 1):
            want = pmodel(torch.from_numpy(x).permute(0, 3, 1, 2),
                          ind=ind).logits.numpy()
            got = model.apply(state.model_variables(), jnp.asarray(x),
                              ind=ind, train=False)
            got = got[0] if isinstance(got, tuple) else got
            np.testing.assert_allclose(np.asarray(got), want, **LOGITS_TOL)

    stray = {"model": {**pmodel.state_dict(),
                       "layer4_0.extra.weight": torch.zeros(3)}}
    torch.save(stray, src)
    with pytest.raises(ValueError, match="cannot place"):
        torch_port_record.port_to_jax_checkpoint(src, dst, 2, arch="resnet9",
                                                 passport_config=cfg)


# --------------------------------------------------------------- --download

@pytest.fixture
def cifar_url(tmp_path, monkeypatch):
    """CIFAR-10's archive (tools/make_cifar_archive.py) published at a
    ``file://`` URL, which ``acquire.ARCHIVES`` names."""
    src = tmp_path / "published"
    make_cifar_archive.main(["--name", "cifar10", "--out", str(src),
                             "--train", "20", "--test", "5"])
    url = f"file://{src / 'cifar-10-python.tar.gz'}"
    monkeypatch.setitem(acquire.ARCHIVES, "cifar10", dataclasses.replace(
        acquire.ARCHIVES["cifar10"], url=url))
    return url


def test_download_fetches_and_extracts_a_cifar_archive(tmp_path, cifar_url):
    """``prepare_archive`` with allow_download on an empty root fetches the
    archive into the root and extracts it; without allow_download the
    same root raises with the URL to fetch."""
    with pytest.raises(FileNotFoundError, match="--download"):
        acquire.prepare_archive(str(tmp_path / "none"), "cifar10")
    root = str(tmp_path / "data")
    folder = acquire.prepare_archive(root, "cifar10", allow_download=True)
    assert folder == os.path.join(root, "cifar-10-batches-py")
    assert sorted(os.listdir(folder))[:2] == ["batches.meta", "data_batch_1"]
    assert os.path.exists(os.path.join(root, "cifar-10-python.tar.gz"))


def test_download_retries_https_over_http(tmp_path, monkeypatch):
    """An https fetch that fails is tried once more over http (reference
    dataset.py:107-130); an http failure is raised as it is."""
    from urllib import request

    calls = []

    def fetch(url, path):
        calls.append(url)
        if url.startswith("https:"):
            raise OSError("refused")
        with open(path, "w") as f:
            f.write("ok")

    monkeypatch.setattr(request, "urlretrieve", fetch)
    path = str(tmp_path / "a" / "f.tar.gz")
    acquire.download_url("https://example.invalid/f.tar.gz", path)
    assert calls == ["https://example.invalid/f.tar.gz",
                     "http://example.invalid/f.tar.gz"]
    assert open(path).read() == "ok"
    calls.clear()
    monkeypatch.setattr(request, "urlretrieve",
                        lambda url, path: (calls.append(url),
                                           (_ for _ in ()).throw(
                                               OSError("down"))))
    with pytest.raises(OSError, match="down"):
        acquire.download_url("http://example.invalid/g.tar", path)
    assert calls == ["http://example.invalid/g.tar"]


def test_download_refuses_an_unsafe_member(tmp_path, monkeypatch):
    """A fetched archive whose member would land outside the root is
    refused before anything is extracted."""
    src = tmp_path / "published"
    src.mkdir()
    (src / "evil.txt").write_text("x")
    archive = str(src / "cifar-10-python.tar.gz")
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(str(src / "evil.txt"), arcname="../evil.txt")
    monkeypatch.setitem(acquire.ARCHIVES, "cifar10", dataclasses.replace(
        acquire.ARCHIVES["cifar10"], url=f"file://{archive}"))
    root = tmp_path / "data"
    with pytest.raises(ValueError, match="unsafe archive member"):
        acquire.locate_cifar(str(root), "cifar10", allow_download=True)
    assert not (tmp_path / "evil.txt").exists()
    assert os.listdir(root) == ["cifar-10-python.tar.gz"]
