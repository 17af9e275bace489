"""The port's host C++ augment against the JAX package's, on the CPU.

``deepipr_tpu_torch/data/native.py`` (csrc/augment.cpp, built by its
``get_lib``) against ``deepipr_tpu/data/native.py``
(native/augment.cpp), both built here with g++ ``-O3 -march=native``:
the native outputs bit for bit, the port's transforms against the JAX
package's defaults bit for bit, the plain versions against that package's
NumPy path bit for bit, native against plain within NATIVE_TOL, the
channel and statistics rules, the build's failures and concurrency, and
the callers (``prepare_wm``, ``serve_http``'s request parse and start-up,
``train_ensemble``'s key candidates) against their JAX counterparts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import threading
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from deepipr_tpu.data import datasets as jax_datasets
from deepipr_tpu.data import native as jax_native

from deepipr_tpu_torch.data import datasets, native
from deepipr_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]
MEAN, STD = datasets.IMAGENET_MEAN, datasets.IMAGENET_STD
# native against plain: one fused multiply-add against a divide and a
# subtract; the largest gap over every byte value and channel is 4.77e-7
NATIVE_TOL = dict(rtol=0.0, atol=1e-6)
URL_TIMEOUT = 60  # seconds: no request may hang a worker


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def jax_lib():
    """The JAX package's native library, built: a silent fallback to its
    NumPy path must not pass for parity."""
    lib = jax_native.get_lib()
    assert lib is not None
    return lib


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package's NumPy path in place of its native C++ one."""
    monkeypatch.setattr(jax_native, "normalize_native", lambda *a: None)
    monkeypatch.setattr(jax_native, "augment_normalize_native",
                        lambda *a: None)


def every_byte() -> np.ndarray:
    """(256, 1, 1, 3) uint8: every byte value in every channel."""
    return np.repeat(np.arange(256, dtype=np.uint8)[:, None, None, None], 3,
                     axis=-1)


def cifar_batch(seed: int, n: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def extreme_draws(pad: int, n: int, seed: int):
    """(ys, xs, flips): offsets 0 and 2 pad on both axes with the flip off
    and on, then random draws."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
    xs = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
    flips = (rng.random(n) < 0.5).astype(np.uint8)
    corners = [(y, x, f) for y in (0, 2 * pad) for x in (0, 2 * pad)
               for f in (0, 1)]
    for i, (y, x, f) in enumerate(corners):
        ys[i], xs[i], flips[i] = y, x, f
    return ys, xs, flips


def test_jax_native_library_is_built(jax_lib):
    assert jax_native.normalize_native(every_byte(), MEAN, STD) is not None


def test_source_is_the_jax_packages_arithmetic():
    """csrc/augment.cpp from its first include on is native/augment.cpp:
    the same entry points and arithmetic, in the same order."""
    def code(path):
        text = path.read_text()
        return text[text.index("#include"):]

    assert code(cuda_build.CSRC / "augment.cpp") == \
        code(ROOT / "native" / "augment.cpp")
    assert native.GXX_FLAGS == ("-O3", "-march=native", "-shared",
                                    "-fPIC")


def test_normalize_native_matches_jax_on_every_byte():
    x = every_byte()
    got = native.normalize_native(x, MEAN, STD)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got,
                                  jax_native.normalize_native(x, MEAN, STD))


@pytest.mark.parametrize("pad", [0, 4])
def test_augment_normalize_native_matches_jax(pad):
    """Every extreme offset and both flips, then random draws, on a
    CIFAR-shaped batch; and on every byte value."""
    x = cifar_batch(pad)
    ys, xs, flips = extreme_draws(pad, len(x), seed=pad + 1)
    got = native.augment_normalize_native(x, ys, xs, flips, pad, MEAN, STD)
    want = jax_native.augment_normalize_native(x, ys, xs, flips, pad, MEAN,
                                               STD)
    np.testing.assert_array_equal(got, want)
    x = np.tile(every_byte(), (1, 2, 2, 1))
    zeros = np.zeros(len(x), np.int32)
    flips = (np.arange(len(x)) % 2).astype(np.uint8)
    np.testing.assert_array_equal(
        native.augment_normalize_native(x, zeros, zeros, flips, 0, MEAN,
                                        STD),
        jax_native.augment_normalize_native(x, zeros, zeros, flips, 0, MEAN,
                                            STD))


@pytest.mark.parametrize("pad,random_crop", [(0, True), (4, True),
                                             (4, False)])
def test_transforms_match_jax_defaults(pad, random_crop):
    """``datasets.normalize`` and ``augment_normalize`` against the JAX
    package's (its native path) on one seeded rng: the same bytes and the
    same draws taken."""
    np.testing.assert_array_equal(datasets.normalize(every_byte()),
                                  jax_datasets.normalize(every_byte()))
    x = cifar_batch(7)
    got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
    calls = native.augment_normalize_native.calls
    for _ in range(2):
        np.testing.assert_array_equal(
            datasets.augment_normalize(x, got_rng, pad, random_crop),
            jax_datasets.augment_normalize(x, want_rng, pad, random_crop))
    assert native.augment_normalize_native.calls == calls + 2
    assert got_rng.random() == want_rng.random()


@pytest.mark.parametrize("pad", [0, 4])
def test_plain_versions_match_jax_numpy_path(numpy_jax, monkeypatch, pad):
    """The plain versions against the JAX package's NumPy path (its
    native path off): directly on the same draws, and as the port's
    transforms with the plain versions in place of the native ones."""
    x = cifar_batch(pad + 10)
    np.testing.assert_array_equal(native.normalize_plain(x, MEAN, STD),
                                  jax_datasets.normalize(x))
    ys, xs, flips = extreme_draws(pad, len(x), seed=pad + 11)
    np.testing.assert_array_equal(
        native.augment_normalize_plain(x, ys, xs, flips, pad, MEAN, STD),
        jax_datasets.normalize(jax_datasets._apply_crop_flip(
            x, ys, xs, flips.astype(bool), pad)))
    monkeypatch.setattr(native, "normalize_native", native.normalize_plain)
    monkeypatch.setattr(native, "augment_normalize_native",
                        native.augment_normalize_plain)
    np.testing.assert_array_equal(datasets.normalize(every_byte()),
                                  jax_datasets.normalize(every_byte()))
    rng, twin = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(datasets.augment_normalize(x, rng, pad),
                                  jax_datasets.augment_normalize(x, twin,
                                                                 pad))


@pytest.mark.parametrize("pad", [0, 4])
def test_native_within_bound_of_plain(pad):
    """The values within NATIVE_TOL; where a pixel is padding and where it
    is flipped exactly, on a constant-255 batch (padding is the only other
    value there)."""
    x = every_byte()
    np.testing.assert_allclose(native.normalize_native(x, MEAN, STD),
                               native.normalize_plain(x, MEAN, STD),
                               **NATIVE_TOL)
    x = cifar_batch(pad + 20)
    ys, xs, flips = extreme_draws(pad, len(x), seed=pad + 21)
    args = (ys, xs, flips, pad, MEAN, STD)
    np.testing.assert_allclose(native.augment_normalize_native(x, *args),
                               native.augment_normalize_plain(x, *args),
                               **NATIVE_TOL)
    white = np.full_like(x, 255)
    white[:, :, 0] = 0  # the first column black: the flip moves it
    got = native.augment_normalize_native(white, *args)
    want = native.augment_normalize_plain(white, *args)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_more_than_16_channels():
    """17 channels: ValueError from the native functions, and from the
    transforms of both packages (the JAX package's takes its NumPy path
    there, which cannot broadcast the 3 ImageNet statistics); the
    statistics must have one entry a channel, as the C++ reads C of
    each."""
    x = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 17),
                                          dtype=np.uint8)
    mean = np.linspace(0.3, 0.6, 17, dtype=np.float32)
    std = np.linspace(0.2, 0.3, 17, dtype=np.float32)
    zeros = np.zeros(2, np.int32)
    calls = native.normalize_native.calls, native.augment_normalize_native.calls
    with pytest.raises(ValueError, match="17 channels"):
        native.normalize_native(x, mean, std)
    with pytest.raises(ValueError, match="17 channels"):
        native.augment_normalize_native(x, zeros, zeros, zeros, 0, mean, std)
    for mod in (datasets, jax_datasets):
        with pytest.raises(ValueError):
            mod.normalize(x)
        with pytest.raises(ValueError):
            mod.augment_normalize(x, np.random.default_rng(1), 1)
    x4 = x[..., :4]
    with pytest.raises(ValueError, match=r"must be \(4,\)"):
        native.normalize_native(x4, MEAN, STD)
    with pytest.raises(ValueError, match=r"must be \(4,\)"):
        native.augment_normalize_native(x4, zeros, zeros, zeros, 0,
                                        mean[:4], STD)
    assert (native.normalize_native.calls,
            native.augment_normalize_native.calls) == calls


def test_calls_are_counted():
    x = cifar_batch(0, n=2)
    before = native.normalize_native.calls, native.augment_normalize_native.calls
    datasets.normalize(x)
    datasets.augment_normalize(x, np.random.default_rng(0), 4)
    datasets.augment_normalize(x, np.random.default_rng(0), 4)
    assert (native.normalize_native.calls,
            native.augment_normalize_native.calls) == (before[0] + 1,
                                                       before[1] + 2)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "build"


def test_missing_gxx_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.normalize_native(every_byte(), MEAN, STD)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.get_lib()
    assert not fresh_build.exists() or not any(fresh_build.iterdir())


def test_failed_compile_raises_with_the_compilers_output(fresh_build,
                                                        tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "augment.cpp").write_text("extern \"C\" void f() { oops; }\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*oops"):
        native.get_lib()
    assert sorted(p.name for p in fresh_build.iterdir()) == []


def test_concurrent_first_builds_give_one_library(fresh_build):
    """Six first builds at once (each compiles to a name of its own and
    renames it into place), then six first loads at once: one library
    file, no temporary left, one loaded library, the JAX package's
    bytes."""
    with ThreadPoolExecutor(6) as pool:
        paths = list(pool.map(lambda _: native.build(), range(6)))
    assert len(set(paths)) == 1 and paths[0].parent == fresh_build
    assert [p.name for p in fresh_build.iterdir()] == [paths[0].name]
    native._lib = None
    with ThreadPoolExecutor(6) as pool:
        libs = list(pool.map(lambda _: native.get_lib(), range(6)))
    assert all(lib is libs[0] for lib in libs)
    np.testing.assert_array_equal(
        native.normalize_native(every_byte(), MEAN, STD),
        jax_native.normalize_native(every_byte(), MEAN, STD))


def test_library_name_covers_source_flags_and_host(monkeypatch):
    path = native.library_path()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("augment-") and path.suffix == ".so"
    monkeypatch.setattr(native, "host_id", lambda: "another host")
    assert native.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "GXX_FLAGS", ("-O2",))
    assert native.library_path() != path


# ------------------------------------------------------------- callers

def test_prepare_wm_matches_jax():
    """The repository's trigger set through both packages' prepare_wm,
    two epochs: the same bytes."""
    pics = str(ROOT / "data" / "trigger_set" / "pics")
    calls = native.normalize_native.calls
    for seed in (0, 4):
        got = list(datasets.prepare_wm(pics, shuffle=True, seed=seed))
        want = list(jax_datasets.prepare_wm(pics, shuffle=True, seed=seed))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["image"].dtype == w["image"].dtype == np.float32
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
    assert native.normalize_native.calls == calls + 2 * len(got)


class _Recorder:
    """A predictor that keeps each batch it is given."""

    def __init__(self):
        self.seen = []

    def predict(self, x):
        self.seen.append(np.array(x))
        return torch.zeros(len(x), dtype=torch.long)


def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=URL_TIMEOUT) as r:
        return r.status


def test_serve_http_parse_matches_jax():
    """The same uint8 requests through both packages' request handlers:
    the padded batches their predictors receive, bit for bit."""
    from deepipr_tpu_torch.cli import serve_http

    spec = importlib.util.spec_from_file_location(
        "jax_tool_serve_http_native", ROOT / "tools" / "serve_http.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    side = 8
    recorders = [_Recorder(), _Recorder()]
    servers = [mod._Server(("127.0.0.1", 0), rec, {"arch": "x"},
                           (side, side, 3))
               for mod, rec in zip((jax_tool, serve_http), recorders)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    calls = native.normalize_native.calls
    rng = np.random.default_rng(6)
    try:
        for n in (1, 3):
            imgs = rng.integers(0, 256, (n, side, side, 3)).astype(np.uint8)
            imgs[0, 0, 0] = (0, 255, 128)
            for s in servers:
                assert _post(f"http://127.0.0.1:{s.server_address[1]}"
                             "/predict", {"images": imgs.tolist()}) == 200
    finally:
        for s, t in zip(servers, threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=URL_TIMEOUT)
    want, got = (rec.seen for rec in recorders)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert native.normalize_native.calls == calls + 2


def test_serve_http_without_gxx_fails_at_start_up(fresh_build, monkeypatch):
    """No g++: ``make_server`` raises before it loads a model, so that no
    request is answered with a 400 for the server's fault."""
    from deepipr_tpu_torch.cli import serve_http

    def no_model(*args, **kwargs):
        raise AssertionError("the model was built before the host library")

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(serve_http, "build_predictor", no_model)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        serve_http.make_server(types.SimpleNamespace(), device="cpu")


class _Stop(Exception):
    pass


def test_train_ensemble_key_candidates_match_jax(monkeypatch):
    """The key and skey candidates each CLI hands to
    ``setup_ensemble_passports`` (its run stops there; the fleet and the
    JAX package's flax models, which they do not depend on, are not
    initialised), from the same synthetic set and seed: bit for bit."""
    from deepipr_tpu.models import registry as jax_registry
    from deepipr_tpu.train import ensemble as jax_ensemble

    from deepipr_tpu_torch.cli import train_ensemble
    from deepipr_tpu_torch.train import ensemble

    seen = {}

    def spy(name):
        def stop(*args, **kwargs):
            seen[name] = [a for a in args if isinstance(a, np.ndarray)]
            raise _Stop

        return stop

    monkeypatch.setattr(ensemble, "setup_ensemble_passports", spy("port"))
    monkeypatch.setattr(jax_ensemble, "setup_ensemble_passports", spy("jax"))
    for mod in (ensemble, jax_ensemble):
        monkeypatch.setattr(mod, "init_ensemble", lambda *a, **k: None)
    monkeypatch.setattr(jax_registry, "build_model", lambda *a, **k:
                        types.SimpleNamespace(init=lambda *a, **k: {}))
    argv = ["--arch", "alexnet", "--members", "2", "--seed", "3",
            "--passport-config", "passport_configs/alexnet_passport.json"]
    monkeypatch.chdir(ROOT)
    calls = native.normalize_native.calls
    with pytest.raises(_Stop):
        train_ensemble.main(argv, device="cpu")
    assert native.normalize_native.calls == calls + 2
    spec = importlib.util.spec_from_file_location(
        "jax_tool_train_ensemble_native", ROOT / "tools" / "train_ensemble.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["train_ensemble.py", *argv])
    with pytest.raises(_Stop):
        jax_tool.main()
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for g, w in zip(seen["port"], seen["jax"]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
