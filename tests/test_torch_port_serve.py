"""The port's serving and ownership-verification path against the JAX package,
and the port's isolation from JAX.

Weights cross from JAX with ``load_jax_variables`` (see
test_torch_port_model.py); both sides run on the CPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepipr_tpu import serve as jax_serve
from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.data import datasets as jax_datasets
from deepipr_tpu.passport import codec as jax_codec
from deepipr_tpu.train import steps as jax_steps
from deepipr_tpu.train.state import TrainState

import deepipr_tpu_torch
from deepipr_tpu_torch import serve
from deepipr_tpu_torch.data import datasets
from deepipr_tpu_torch.interop.jax_params import load_jax_variables
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.passport import codec
from deepipr_tpu_torch.train import steps

from deepipr_tpu.utils.config import load_passport_config

from test_torch_port_model import CONFIGS, LOGITS_TOL, resnet_pair

PORT_DIR = Path(deepipr_tpu_torch.__file__).resolve().parent


def _embed_signature(jmodel, v, input_shape):
    """Negate the conv filters whose derived scale disagrees with ``b``, so
    that the scales carry the signature as a trained model's do and the
    genuine passports verify at 1.0 (the derived scale is linear in the
    filter)."""
    aff = jax_derived_affines(jmodel, v, input_shape, private=True)
    for path, aux in aff.items():
        node = v["params"]
        for part in path.split("/"):
            node = node[part]
        wrong = np.sign(np.asarray(aux["scale"])) != np.asarray(aux["b"])
        node["conv"]["kernel"] = np.where(wrong, -node["conv"]["kernel"],
                                          node["conv"]["kernel"])
    return v


def _verified_pair(arch, config, size):
    jmodel, v, pmodel = resnet_pair(arch, config, size, seed=5)
    v = _embed_signature(jmodel, v, (1, size, size, 3))
    load_jax_variables(pmodel, v)
    return jmodel, v, pmodel, TrainState.create(v, optax.sgd(0.1))


def _forged(v, seed):
    """Forged passports drawn with numpy: the JAX tree (NHWC) and the same
    values keyed as the port's buffers (NCHW)."""
    rng = np.random.default_rng(seed)
    jtree, port = {}, {}

    def walk(node, path, out):
        for k, a in node.items():
            if isinstance(a, dict):
                out[k] = {}
                walk(a, path + [k], out[k])
            else:
                out[k] = rng.normal(size=a.shape).astype(np.float32)
                port[".".join(path + [k])] = out[k].transpose(0, 3, 1, 2)

    walk(v["passport"], [], jtree)
    return jtree, port


@pytest.fixture(scope="module")
def resnet9():
    """ResNet9 private with the text "hi" in layer4_0/convbn_2's signature."""
    config = load_passport_config(str(CONFIGS / "resnet9_passport.json"))
    config["layer4"]["0"]["convbn_2"] = "hi"
    return _verified_pair("resnet9", config, 16)


def test_verify_ownership_matches_jax(resnet9):
    jmodel, _, pmodel, state = resnet9
    want = jax_serve.verify_ownership(jmodel, state, (1, 16, 16, 3),
                                      private=True, num_chars=4)
    got = serve.verify_ownership(pmodel, (1, 16, 16, 3), private=True,
                                 num_chars=4, device="cpu")
    assert got["verified"] and want["verified"]
    assert got["detection_rate"] == want["detection_rate"] == 1.0
    assert got["layers"] == want["layers"]
    # the decoded ASCII reads the derived scales' signs, equal sign for sign
    assert got["decoded"] == want["decoded"]
    assert got["decoded"]["layer4_0/convbn_2"][:2] == "hi"


def test_forged_passports_fail_alike(resnet9):
    jmodel, v, pmodel, state = resnet9
    jforged, pforged = _forged(v, seed=9)
    own = {k: b.clone() for k, b in serve.passports(pmodel).items()}
    want = jax_serve.verify_ownership(jmodel, state, (1, 16, 16, 3),
                                      private=True, claimed_passports=jforged)
    got = serve.verify_ownership(pmodel, (1, 16, 16, 3), private=True,
                                 claimed_passports=pforged, device="cpu")
    assert got["layers"] == want["layers"]
    assert not got["verified"]
    assert got["detection_rate"] == want["detection_rate"] < 0.7
    for k, b in serve.passports(pmodel).items():  # the claim left no trace
        assert torch.equal(b, own[k])


def test_claim_must_name_the_models_passports(resnet9):
    _, v, pmodel, _ = resnet9
    _, pforged = _forged(v, seed=2)
    pforged.pop(sorted(pforged)[0])
    with pytest.raises(ValueError):
        serve.verify_ownership(pmodel, (1, 16, 16, 3), private=True,
                               claimed_passports=pforged, device="cpu")


@pytest.mark.parametrize("private", [True, False])
def test_signature_fn_matches_jax(resnet9, private):
    jmodel, _, pmodel, state = resnet9
    want = jax_steps.make_signature_fn(jmodel, (1, 16, 16, 3), private)(state)
    got = steps.make_signature_fn(pmodel, (1, 16, 16, 3), private,
                                  device="cpu")()
    assert got == want
    assert got == steps.test_signature(pmodel, (1, 16, 16, 3), private,
                                       device="cpu")


@pytest.mark.parametrize("ind", [0, 1])
def test_predictor_matches_jax(resnet9, ind):
    jmodel, _, pmodel, state = resnet9
    x = np.random.default_rng(4).normal(size=(3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax_serve.Predictor(jmodel, state, ind=ind).logits(x))
    pred = serve.Predictor(pmodel, ind=ind, device="cpu")
    np.testing.assert_allclose(pred.logits(x).numpy(), want, **LOGITS_TOL)
    np.testing.assert_array_equal(pred.predict(x).numpy(), want.argmax(-1))


@pytest.mark.parametrize("ind", [0, 1])
def test_evaluate_matches_jax(resnet9, ind):
    jmodel, _, pmodel, state = resnet9
    _, _, vx, vy = datasets.synthetic_dataset(num_train=0, num_test=8,
                                              size=16)
    batches = [{"image": datasets.normalize(vx[i:i + 4]), "label": vy[i:i + 4]}
               for i in (0, 4)]
    want = jax_steps.evaluate(jmodel, state, [
        {k: jnp.asarray(a) for k, a in b.items()} for b in batches], ind=ind)
    got = steps.evaluate(pmodel, batches, ind=ind, device="cpu")
    assert got["acc"] == want["acc"]
    # a mean of per-image CEs over logits held at LOGITS_TOL
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3, atol=1e-3)


def test_resnet18_full_width_matches_jax():
    """ResNet18Private at CIFAR width: private logits and verification."""
    jmodel, _, pmodel, state = _verified_pair(
        "resnet18", "resnet18_passport.json", 32)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(state.model_variables(), jnp.asarray(x),
                                   ind=1, train=False))
    got = serve.Predictor(pmodel, ind=1, device="cpu").logits(x)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    res = serve.verify_ownership(pmodel, (1, 32, 32, 3), private=True,
                                 device="cpu")
    jres = jax_serve.verify_ownership(jmodel, state, (1, 32, 32, 3),
                                      private=True)
    assert res["layers"] == jres["layers"]
    assert len(res["layers"]) == 5 and res["verified"]


# ------------------------------------------------------------- codec, data

def test_codec_matches_jax():
    rng = np.random.default_rng(0)
    scale = rng.normal(size=64).astype(np.float32)
    b = np.where(rng.random(64) < 0.5, 1.0, -1.0).astype(np.float32)
    assert np.array_equal(codec.string_to_bits("Ok!"),
                          jax_codec.string_to_bits("Ok!"))
    assert codec.bits_to_string(codec.string_to_bits("Ok!")) == "Ok!"
    assert np.array_equal(codec.decode_bits(torch.from_numpy(scale)).numpy(),
                          np.asarray(jax_codec.decode_bits(jnp.asarray(scale))))
    assert codec.decode_string(torch.from_numpy(scale), 8) == \
        jax_codec.decode_string(jnp.asarray(scale), 8)
    assert float(codec.bit_accuracy(torch.from_numpy(scale),
                                    torch.from_numpy(b))) == \
        float(jax_codec.bit_accuracy(jnp.asarray(scale), jnp.asarray(b)))


def test_encode_signature_spec():
    g = torch.Generator().manual_seed(0)
    b = codec.encode_signature(g, 64, "hi")
    want = np.asarray(jax_codec.encode_signature(jax.random.key(0), 64, "hi"))
    # the text bits agree; the random tail comes from each side's own RNG
    np.testing.assert_array_equal(b[:16].numpy(), want[:16])
    assert set(b[16:].tolist()) <= {-1.0, 1.0}
    assert codec.encode_signature(g, 8, -1).tolist() == [-1.0] * 8
    with pytest.raises(ValueError):
        codec.encode_signature(g, 8, "toolong")


def test_synthetic_dataset_and_normalize_match_jax():
    got = datasets.synthetic_dataset(num_train=16, num_test=8, size=16, seed=3)
    want = jax_datasets.synthetic_dataset(num_train=16, num_test=8, size=16,
                                          seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(datasets.normalize(got[0]),
                                  jax_datasets.normalize(got[0]))


# -------------------------------------------------------- entry points

def test_entry_points_raise_without_a_gpu(resnet9, monkeypatch):
    _, _, pmodel, _ = resnet9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: build_model("resnet9", 10),
        lambda: serve.Predictor(pmodel),
        lambda: serve.verify_ownership(pmodel, (1, 16, 16, 3), private=True),
        lambda: steps.make_eval_step(pmodel),
        lambda: steps.make_dual_eval_step(pmodel),
        lambda: steps.make_signature_fn(pmodel, (1, 16, 16, 3), True),
        lambda: steps.evaluate(pmodel, []),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_options_raise(resnet9):
    _, _, pmodel, _ = resnet9
    with pytest.raises(ValueError, match="unknown arch"):  # as in JAX
        build_model("resnet101", 10, device="cpu")
    with pytest.raises(ValueError):  # the model lives on the CPU
        serve.Predictor(pmodel, device="meta")


# ------------------------------------------------------------- isolation

def test_port_imports_no_jax():
    modules = sorted(
        "deepipr_tpu_torch." + ".".join(p.relative_to(PORT_DIR).with_suffix("")
                                        .parts).replace(".__init__", "")
        for p in PORT_DIR.rglob("*.py"))
    # the entry points and what they run are among them
    assert {"deepipr_tpu_torch.cli.train_v1", "deepipr_tpu_torch.cli.train_v23",
            "deepipr_tpu_torch.train.experiment",
            "deepipr_tpu_torch.utils.checkpoint"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'deepipr_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT_DIR.parent, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b"
        r"|\bfrom deepipr_tpu\.|\bimport deepipr_tpu\b", re.M)
    files = list(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"]
    assert len(files) > 20
    assert PORT_DIR / "cli" / "train_v23.py" in files
    hits = [(f.name, m.group(0)) for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits
