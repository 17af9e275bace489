"""The port's deployment and dispute tools against the JAX package's, on the
CPU: passport commitments (passport/commitment.py) and the CLIs
``verify_ownership``, ``export_deployment``, ``serve_http`` and
``export_torch_checkpoint`` (``deepipr_tpu_torch/cli/``) beside the
repository's ``tools/`` scripts of the same names, run in-process.

Weights cross from JAX with ``load_jax_variables`` (ResNet9 V2 at 16 px,
the text "hi" in layer4_0/convbn_2's signature, its conv filters signed so
that the genuine passports verify, as tests/test_torch_port_serve.py does);
the JAX tools read a checkpoint written by the JAX package's ``save_state``,
the port's CLIs one of the port's on the same weights.
"""

import hashlib
import importlib.util
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepipr_tpu.interop.fold import fold_for_inference as jax_fold
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.passport.commitment import commit as jax_commit
from deepipr_tpu.passport.commitment import \
    verify_commitment as jax_verify_commitment
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.utils.checkpoint import save_state as jax_save_state
from deepipr_tpu.utils.config import load_passport_config

import deepipr_tpu_torch
from deepipr_tpu_torch.cli import (
    export_deployment,
    export_torch_checkpoint,
    serve_http,
    train_ensemble,
    verify_ownership,
)
from deepipr_tpu_torch.data.datasets import normalize
from deepipr_tpu_torch.interop.jax_params import (
    export_jax_variables,
    load_jax_variables,
)
from deepipr_tpu_torch.interop.torch_import import load_torch_checkpoint
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.passport.commitment import (
    _leaves,
    canonical_digest,
    commit,
    verify_commitment,
)
from deepipr_tpu_torch.serve import Predictor, passports
from deepipr_tpu_torch.serve import verify_ownership as port_verify
from deepipr_tpu_torch.train import ensemble
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.utils.checkpoint import load_model, save_state
from deepipr_tpu_torch.utils.config import (
    construct_passport_kwargs,
    mark_separate_stats,
)

from test_torch_port_interop import FOLD_TOL
from test_torch_port_model import CONFIGS, RNGS, numpy_variables
from test_torch_port_serve import _embed_signature, _forged

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = Path(deepipr_tpu_torch.__file__).resolve().parent
SIDE = 16
SHAPE = (1, SIDE, SIDE, 3)
COMMON = ["--arch", "resnet9", "--imgcrop", str(SIDE)]
URL_TIMEOUT = 60  # seconds: no request may hang a worker


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(v):
    return JaxTrainState.create(jax.tree.map(jnp.asarray, v), optax.sgd(0.0))


@pytest.fixture(scope="module")
def owner(tmp_path_factory):
    """ResNet9 V2 on equal weights in both packages, verified, with
    checkpoints of both (genuine and with forged passports) and a config
    file that names its "hi"."""
    folder = tmp_path_factory.mktemp("owner")
    config = load_passport_config(str(CONFIGS / "resnet9_passport.json"))
    config["layer4"]["0"]["convbn_2"] = "hi"
    cfg = folder / "resnet9_hi.json"
    cfg.write_text(json.dumps(config))
    kw, _ = construct_passport_kwargs(config, "bn", "random", 0.1)
    jmodel = jax_resnet.ResNet9(num_classes=10, passport_kwargs=kw,
                                private=True)
    # resnet_pair's model, initialised under jit (half the eager init's time)
    v = numpy_variables(jax.jit(lambda x: jmodel.init(RNGS, x, train=True))(
        jnp.zeros((2, SIDE, SIDE, 3))), seed=5)
    v = _embed_signature(jmodel, v, SHAPE)
    pmodel = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                         input_size=SIDE, device="cpu")
    load_jax_variables(pmodel, v)
    jforged, pforged = _forged(v, seed=9)
    fv = {**v, "passport": jforged}
    fmodel = build_model("resnet9", 10, passport_kwargs=pmodel.passport_kwargs,
                         private=True, input_size=SIDE, device="cpu")
    load_jax_variables(fmodel, fv)
    assert set(pforged) == set(passports(fmodel))
    paths = {}
    for tag, jv, pm in (("genuine", v, pmodel), ("forged", fv, fmodel)):
        paths[f"jax_{tag}"] = str(folder / f"jax_{tag}.ckpt")
        jax_save_state(paths[f"jax_{tag}"], _jax_state(jv))
        paths[f"port_{tag}"] = str(folder / f"port_{tag}.ckpt")
        save_state(paths[f"port_{tag}"], TrainState.create(pm, 0.0))
    return {"jmodel": jmodel, "v": v, "pmodel": pmodel, "fmodel": fmodel,
            "jstate": _jax_state(v), "cfg": str(cfg), "folder": folder,
            **paths}


def _run_tool(name, argv, capsys):
    """tools/<name>.py's main() in-process on ``argv``: (exit code,
    stdout)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    capsys.readouterr()
    argv0, code = sys.argv, 0
    sys.argv = [f"{name}.py", *argv]
    try:
        tool.main()
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv0
    return code, capsys.readouterr().out


# ------------------------------------------------------------ commitment

@pytest.mark.parametrize("binding", [True, False], ids=["weights", "secrets"])
@pytest.mark.parametrize("meta", [None, {"owner": "ACME",
                                         "date": "2026-08-17"}],
                         ids=["no_meta", "meta"])
def test_commitment_records_cross_verify(owner, binding, meta):
    """Records of both packages equal digest for digest, string for string,
    and each verifies in the other package; forged passports fail both."""
    shape = SHAPE if binding else None
    want = jax_commit(owner["jstate"], model=owner["jmodel"] if binding
                      else None, input_shape=shape, meta=meta)
    got = commit(owner["pmodel"], input_shape=shape, meta=meta)
    assert got == want
    assert ("derived_signs_sha256" in got) == binding
    assert jax_verify_commitment(owner["jstate"], got, model=owner["jmodel"],
                                 input_shape=SHAPE)
    assert verify_commitment(owner["pmodel"], want, input_shape=SHAPE)
    assert not verify_commitment(owner["fmodel"], want, input_shape=SHAPE)
    if meta:
        tampered = {**want, "meta": {**meta, "owner": "EVE"}}
        assert not verify_commitment(owner["pmodel"], tampered)


def test_commitment_hashes_jax_layout_and_numpy_strings(owner):
    """The passport digest is JAX's only in JAX's layout with numpy's dtype
    and shape strings: the port's NCHW buffers, or torch's strings
    (``torch.float32``, ``torch.Size([...])``), give other digests."""
    want = jax_commit(owner["jstate"])["passport_sha256"]
    assert commit(owner["pmodel"])["passport_sha256"] == want
    nchw = {}
    for name, buf in passports(owner["pmodel"]).items():
        mod, leaf = name.rsplit(".", 1)
        nchw.setdefault(mod.replace(".", "/"), {})[leaf] = buf.numpy()
    assert canonical_digest(nchw).hex() != want

    h = hashlib.sha256()  # canonical_digest with torch's strings
    tree = export_jax_variables(owner["pmodel"])["passport"]
    for key, a in sorted(_leaves(tree), key=lambda e: e[0]):
        t = torch.from_numpy(a)
        h.update(key.encode())
        h.update(str(t.dtype).encode())
        h.update(str(t.shape).encode())
        h.update(t.double().numpy().tobytes())
    assert h.hexdigest() != want


# ------------------------------------------------------ verify_ownership

def _verify_argv(owner, pkg, ckpt, *extra):
    return COMMON + ["--passport-config", owner["cfg"], "--ckpt",
                     owner[f"{pkg}_{ckpt}"], *extra]


@pytest.mark.parametrize("case", ["owner", "claimed", "check"])
def test_verify_ownership_cli_matches_jax_tool(owner, case, capsys):
    """The printed JSON (sorted keys) equals tools/verify_ownership.py's,
    string for string, and so do the exit statuses: 0 for the owner with
    --num-chars and --commit, 1 for forged passports (--claimed-ckpt), 0
    for --check-commitment of the other package's record."""
    folder = owner["folder"]
    extra = {"owner": lambda pkg: ["--num-chars", "2", "--commit",
                                   str(folder / f"{pkg}_rec.json")],
             "claimed": lambda pkg: ["--claimed-ckpt",
                                     owner[f"{pkg}_forged"]],
             "check": lambda pkg: ["--check-commitment",
                                   str(folder / f"{pkg}_cross.json")]}[case]
    if case == "check":  # each checks the other package's record
        (folder / "jax_cross.json").write_text(json.dumps(
            commit(owner["pmodel"], input_shape=SHAPE)))
        (folder / "port_cross.json").write_text(json.dumps(
            jax_commit(owner["jstate"], model=owner["jmodel"],
                       input_shape=SHAPE)))
    code, jtext = _run_tool("verify_ownership",
                            _verify_argv(owner, "jax", "genuine",
                                         *extra("jax")), capsys)
    res = verify_ownership.main(_verify_argv(owner, "port", "genuine",
                                             *extra("port")), device="cpu")
    ptext = capsys.readouterr().out
    if case == "owner":
        jtext = jtext.replace("jax_rec.json", "port_rec.json")
        assert json.loads((folder / "jax_rec.json").read_text()) == \
            json.loads((folder / "port_rec.json").read_text())
        assert res["decoded"]["layer4_0/convbn_2"] == "hi"
    assert ptext == jtext
    assert code == (0 if res["verified"] else 1)
    assert code == {"owner": 0, "claimed": 1, "check": 0}[case]
    if case == "claimed":
        assert res["detection_rate"] < 0.7
    if case == "check":
        assert res["commitment_valid"] is True


# ----------------------------------------------------- export_deployment

def test_export_deployment_matches_jax_fold(owner, capsys):
    """The artifact's logits equal JAX's fold_for_inference's at the fold
    tolerance; it holds no passport, signature or BN statistic; the
    summary line is JAX's."""
    folder = owner["folder"]
    common = COMMON + ["--passport-config", owner["cfg"]]
    _, jtext = _run_tool("export_deployment", common + [
        "--ckpt", owner["jax_genuine"], "--out", str(folder / "jax.dep")],
        capsys)
    out = folder / "port.dep"
    export_deployment.main(common + ["--ckpt", owner["port_genuine"],
                                     "--out", str(out)], device="cpu")
    assert capsys.readouterr().out == jtext.replace("jax.dep", "port.dep")

    names = torch.load(out, map_location="cpu", weights_only=True)["model"]
    assert names and not [k for k in names if k.rsplit(".", 1)[-1] in (
        "key", "skey", "b", "running_mean", "running_var", "scale")]
    art = load_model(str(out), build_model("resnet9", 10, "none",
                                           input_size=SIDE, device="cpu"))
    x = np.random.default_rng(3).normal(size=(4, SIDE, SIDE, 3)).astype(
        np.float32)
    got = Predictor(art, device="cpu").logits(x).numpy()
    jfm, jfv = jax_fold(owner["jmodel"], owner["v"], SHAPE, ind=0)
    want = np.asarray(jfm.apply(jax.tree.map(jnp.asarray, jfv),
                                jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, **FOLD_TOL)


# ----------------------------------------------- export_torch_checkpoint

def test_export_torch_checkpoint_matches_jax_tool(owner, capsys):
    """The .pth equals tools/export_torch_checkpoint.py's key for key, bit
    for bit; it reads back into a fresh port model that verifies."""
    folder = owner["folder"]
    common = COMMON + ["--passport-config", owner["cfg"]]
    _, jtext = _run_tool("export_torch_checkpoint", common + [
        "--ckpt", owner["jax_genuine"], "--out", str(folder / "jax.pth")],
        capsys)
    sd = export_torch_checkpoint.main(common + [
        "--ckpt", owner["port_genuine"], "--out", str(folder / "port.pth")],
        device="cpu")
    assert capsys.readouterr().out == jtext.replace("jax.pth", "port.pth")
    want = torch.load(folder / "jax.pth", map_location="cpu",
                      weights_only=True)
    assert list(sd) == list(want) or sorted(sd) == sorted(want)
    for k, w in want.items():
        assert sd[k].dtype == w.dtype and torch.equal(sd[k], w), k
    fresh = build_model("resnet9", 10, passport_kwargs=owner[
        "pmodel"].passport_kwargs, private=True, input_size=SIDE, seed=3,
        device="cpu")
    load_torch_checkpoint(str(folder / "port.pth"), fresh)
    assert port_verify(fresh, SHAPE, private=True, device="cpu")["verified"]


def test_export_torch_checkpoint_refuses_separate_stats(tmp_path):
    with open(CONFIGS / "resnet9_passport.json") as f:
        kw, _ = construct_passport_kwargs(json.load(f), "bn", "shuffle", 0.1)
    mark_separate_stats(kw)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        input_size=SIDE, device="cpu")
    ckpt = str(tmp_path / "sep.ckpt")
    save_state(ckpt, TrainState.create(model, 0.0))
    with pytest.raises(ValueError, match="separate_stats"):
        export_torch_checkpoint.main(COMMON + [
            "--passport-config", str(CONFIGS / "resnet9_passport.json"),
            "--ckpt", ckpt, "--out", str(tmp_path / "sep.pth")],
            device="cpu")


# ------------------------------------------------------------ serve_http

def _request(url, obj=None):
    """(status, JSON body) of a GET (obj None) or a JSON POST."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=URL_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module", params=["folded_resnet9_v2",
                                        "unfolded_alexnet_v1"])
def server(request, owner, tmp_path_factory):
    """A running server: the folded V2 ResNet9, or an AlexNet V1 served
    unfolded (--no-folded --no-private: derived affines every request)."""
    if request.param == "folded_resnet9_v2":
        argv = COMMON + ["--passport-config", owner["cfg"], "--ckpt",
                         owner["port_genuine"]]
    else:
        config = str(CONFIGS / "alexnet_passport.json")
        with open(config) as f:
            kw, _ = construct_passport_kwargs(json.load(f), "bn", "shuffle",
                                              0.1)
        v1 = build_model("alexnet", 10, passport_kwargs=kw, private=False,
                         input_size=SIDE, seed=4, device="cpu")
        ckpt = str(tmp_path_factory.mktemp("v1") / "v1.ckpt")
        save_state(ckpt, TrainState.create(v1, 0.0))
        argv = ["--arch", "alexnet", "--imgcrop", str(SIDE),
                "--passport-config", config, "--ckpt", ckpt, "--no-folded",
                "--no-private"]
    args = serve_http.build_parser().parse_args(argv)
    srv = serve_http.make_server(args, port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv, args
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=URL_TIMEOUT)


def _uint8(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIDE, SIDE, 3)).astype(np.uint8)


def test_healthz(server):
    url, _, args = server
    code, body = _request(url + "/healthz")
    assert code == 200
    assert body == {"ok": True, "arch": args.arch, "folded": args.folded,
                    "num_classes": 10, "image_shape": [SIDE, SIDE, 3]}


def test_classes_equal_the_predictors(server):
    """uint8 and normalized requests of 1, 3 and 8 rows: the classes are
    the argmax of an in-process Predictor's logits on the same model."""
    url, srv, _ = server
    pred = srv.predictor
    for n, seed in ((1, 0), (3, 1), (8, 2)):
        imgs = _uint8(n, seed)
        want = pred.logits(normalize(imgs)).argmax(-1).tolist()
        for obj in ({"images": imgs.tolist()},
                    {"images": normalize(imgs).tolist()}):
            code, body = _request(url + "/predict", obj)
            assert code == 200 and body["classes"] == want
            assert body["latency_ms"] >= 0
    assert not pred.model.training


def test_padding_consistency(server):
    """A batch-1 request (bucket 1) and the same image in a batch of 3
    (bucket 8) agree: padding cannot leak (tests/test_serving_http.py)."""
    url, _, _ = server
    img = _uint8(1, 5)[0]
    _, one = _request(url + "/predict", {"images": img.tolist()})
    _, three = _request(url + "/predict",
                        {"images": np.stack([img] * 3).tolist()})
    assert one["classes"][0] == three["classes"][0]
    assert len(set(three["classes"])) == 1


def test_concurrent_requests_answer_as_serial_twins(server):
    url, _, _ = server
    batches = [_uint8(n, 10 + n) for n in range(1, 9)]
    serial = [_request(url + "/predict", {"images": b.tolist()})[1]["classes"]
              for b in batches]
    with ThreadPoolExecutor(8) as pool:
        answers = list(pool.map(
            lambda b: _request(url + "/predict", {"images": b.tolist()}),
            batches))
    assert [code for code, _ in answers] == [200] * 8
    assert [body["classes"] for _, body in answers] == serial


class _Boom:
    def predict(self, x):
        raise RuntimeError("boom")


@pytest.fixture(scope="module")
def stub_servers():
    """JAX's and the port's request handlers around a predictor that
    raises: the error bodies of both, no model needed."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_serve_http", ROOT / "tools" / "serve_http.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    servers = [mod._Server(("127.0.0.1", 0), _Boom(), {"arch": "x"},
                           (SIDE, SIDE, 3)) for mod in (jax_tool, serve_http)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        yield [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    finally:
        for s, t in zip(servers, threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=URL_TIMEOUT)


@pytest.mark.parametrize("case", ["bad_json", "bad_shape", "oversized",
                                  "unknown_get", "unknown_post", "failure"])
def test_error_bodies_are_jax_wording(stub_servers, case):
    path, obj = {
        "bad_json": ("/predict", {"images": "nope"}),
        "bad_shape": ("/predict", {"images": np.zeros((2, 5, 5, 3)).tolist()}),
        "oversized": ("/predict", {"images": np.zeros((257, 2, 2, 3))
                                   .tolist()}),
        "unknown_get": ("/nope", None),
        "unknown_post": ("/nope", {"images": []}),
        "failure": ("/predict", {"images": np.zeros((2, SIDE, SIDE, 3))
                                 .tolist()}),
    }[case]
    jax_url, port_url = stub_servers
    want = _request(jax_url + path, obj)
    got = _request(port_url + path, obj)
    assert got == want
    assert got[0] == {"bad_json": 400, "bad_shape": 400, "oversized": 413,
                      "unknown_get": 404, "unknown_post": 404,
                      "failure": 500}[case]


def test_real_server_rejects_bad_requests(server):
    url, _, _ = server
    code, body = _request(url + "/predict",
                          {"images": np.zeros((2, 5, 5, 3)).tolist()})
    assert code == 400 and body["error"].startswith("images must be")
    code, _ = _request(url + "/predict",
                       {"images": np.zeros((257, 2, 2, 3)).tolist()})
    assert code == 413


# ---------------------------------------------------------- entry points

def test_entry_points_raise_without_a_gpu(owner, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = COMMON + ["--passport-config", owner["cfg"], "--ckpt",
                     owner["port_genuine"]]
    out = str(owner["folder"] / "never")
    calls = [
        lambda: verify_ownership.main(argv),
        lambda: export_deployment.main(argv + ["--out", out]),
        lambda: export_torch_checkpoint.main(argv + ["--out", out]),
        lambda: serve_http.make_server(
            serve_http.build_parser().parse_args(argv)),
        lambda: train_ensemble.main(["--passport-config", owner["cfg"]]),
        lambda: ensemble.make_ensemble_signature_fn(SHAPE, True),
        lambda: ensemble.make_ensemble_epoch_fn([], True, 8, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


NEW_MODULES = [
    "deepipr_tpu_torch.passport.commitment",
    "deepipr_tpu_torch.train.ensemble",
    "deepipr_tpu_torch.cli.common",
    "deepipr_tpu_torch.cli.train_ensemble",
    "deepipr_tpu_torch.cli.verify_ownership",
    "deepipr_tpu_torch.cli.export_deployment",
    "deepipr_tpu_torch.cli.serve_http",
    "deepipr_tpu_torch.cli.export_torch_checkpoint",
]


def test_new_modules_import_no_jax():
    """The slice's modules (which test_torch_port_serve.py's guard finds
    under cli/ and beside them) import neither JAX nor deepipr_tpu."""
    found = {"deepipr_tpu_torch." + ".".join(
        p.relative_to(PORT_DIR).with_suffix("").parts)
        for p in PORT_DIR.rglob("*.py")}
    assert set(NEW_MODULES) <= found
    code = (
        "import importlib, sys\n"
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'deepipr_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT_DIR.parent, timeout=120)
    assert out.returncode == 0, out.stderr
