"""The port's multi-process training against the JAX package's mesh, on the
CPU: the mesh and its tensor-parallel choice, process-group set-up, V3's
padding to the batch axis, and, launched as real processes over ``gloo``
(tests/torch_port_parallel_worker.py, which imports no JAX), data-parallel
steps and epochs, tensor parallelism, ``shard_ensemble`` and the
multi-process checkpoints.

The JAX side runs in this process on the conftest's 8 virtual devices:
``make_train_step`` on a 2-device mesh, ``make_epoch_train_fn`` on a
4-device mesh, and the sharded fleet on a 4x2 mesh, each at the tolerances
of the port's single-process comparison with JAX (W7: JAX's draws and
permutations are handed to the ranks). Two launches (2 and 4 ranks) serve
every launched test; the ranks rendezvous through a ``file://`` store in
the test's temporary directory, each on one intra-op thread.
"""

import csv
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from deepipr_tpu.data.device_augment import make_device_augment
from deepipr_tpu.models import resnet as jax_resnet
from deepipr_tpu.parallel import mesh as jax_mesh
from deepipr_tpu.train import ensemble as jax_ens
from deepipr_tpu.train.epoch import (
    device_resident as jax_device_resident,
    epoch_permutation as jax_epoch_permutation,
    make_epoch_train_fn as jax_epoch_fn,
)
from deepipr_tpu.train.experiment import (
    ClassificationExperiment as JaxExperiment,
)
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState
from deepipr_tpu.train.steps import make_train_step as jax_train_step
from deepipr_tpu.utils.config import (
    construct_passport_kwargs,
    load_passport_config,
)

from deepipr_tpu_torch.cli import train_v23
from deepipr_tpu_torch.data.datasets import DataLoader
from deepipr_tpu_torch.interop.jax_params import _port_entry, jax_state_dict
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.parallel import distributed
from deepipr_tpu_torch.parallel.mesh import make_mesh, model_parallel_spec
from deepipr_tpu_torch.train.experiment import ClassificationExperiment

from test_torch_port_ensemble import (
    METRIC_TOL as FLEET_METRIC_TOL,
    SEED as FLEET_SEED,
    SIDE as FLEET_SIDE,
    UPDATE_NORM_TOL as FLEET_UPDATE_NORM_TOL,
)
from test_torch_port_model import CONFIGS, RNGS, numpy_variables
from test_torch_port_train import (
    BATCH,
    LR,
    MOMENTUM_NORM_TOL,
    PAD,
    PARAM_TOL,
    SIDE,
    _batches as step_batches,
    jax_draws,
)
from test_train import tiny_passport_model, toy_batch

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_port_parallel_worker.py")
LAUNCH_TIMEOUT = 300  # seconds for every rank of one launch
# history.csv columns of the wall clock, which no two runs share
CLOCK_COLUMNS = ("train_time", "train_images_per_sec")
# tests/test_train.py:322-412, the replicated step against the
# model-sharded one: BasicBlock nets, and the Bottleneck's looser bound
TP_TOL = {"basic": (1e-6, dict(rtol=1e-5, atol=1e-6)),
          "bottleneck": (2e-3, dict(rtol=5e-2, atol=5e-4))}
CLI_ARGV = ["--arch", "resnet9", "--dataset", "synthetic",
            "--passport-config", "passport_configs/resnet9_passport.json",
            "--key-type", "random", "--epochs", "1", "--batch-size", "16",
            "--epoch-scan"]
SIZES = {"synthetic_train": 64, "synthetic_test": 32}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _resnet9_init():
    """The private ResNet9 of tests/test_torch_port_train.py's step cases
    and its variables (flax's init, jitted; BN statistics redrawn), made
    once for both launches."""
    cfg = load_passport_config(str(CONFIGS / "resnet9_passport.json"))
    kw, _ = construct_passport_kwargs(cfg, "bn", "random", 0.1)
    jmodel = jax_resnet.ResNet9(num_classes=10, passport_kwargs=kw,
                                private=True)
    v = jax.jit(lambda x: jmodel.init(RNGS, x, train=True))(
        jnp.zeros((2, SIDE, SIDE, 3)))
    return jmodel, numpy_variables(v, seed=0)


def _jax_fleet():
    """tests/test_ensemble.py's fleet of two (JAX's init_ensemble, jitted)
    at the port fleet test's side."""
    model = tiny_passport_model(private=True)
    ens = jax.jit(lambda: jax_ens.init_ensemble(
        model, jax_sgd(LR), (2, FLEET_SIDE, FLEET_SIDE, 3), n=2,
        seed=FLEET_SEED))()
    return model, ens


def _tensors(tree):
    """numpy leaves as tensors, for the ranks' ``weights_only`` load."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def _launch(task, world, directory, inputs):
    """Start ``world`` ranks of the worker on ``task``; returns them."""
    torch.save(_tensors(inputs), directory / "inputs.pt")
    path = [str(REPO), str(REPO / "tests")]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path),
           "OMP_NUM_THREADS": "1"}
    store = directory / "store"
    return [subprocess.Popen(
        [sys.executable, str(WORKER), task, str(r), str(world), str(store),
         str(directory)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs, directory):
    """Wait for every rank (killing them all once LAUNCH_TIMEOUT has
    passed); returns each rank's results."""
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.communicate()
        raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK-OK" in out, out[-4000:]
    return [torch.load(directory / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _history(logdir):
    with open(os.path.join(logdir, "history.csv")) as f:
        return list(csv.DictReader(f))


def _assert_step_state(got, jstate, metrics):
    """A rank's trained state and metrics against JAX's at the tolerances
    of tests/test_torch_port_train.py::test_train_steps_match_jax."""
    for jm, pm in metrics:
        assert sorted(pm) == sorted(jm)
        assert pm["sign_acc"] == float(jm["sign_acc"])
        for k in jm:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    want = jax_state_dict({"params": jax.device_get(jstate.params)})
    for name, w in want.items():
        np.testing.assert_allclose(got["model"][name].numpy(), w,
                                   err_msg=name, **PARAM_TOL)
    stats = jax_state_dict({"batch_stats": jax.device_get(jstate.batch_stats)})
    for name, w in stats.items():
        np.testing.assert_allclose(got["model"][name].numpy(), w, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    trace = jax_state_dict({"params": jax.device_get(
        jstate.opt_state[1].trace)})
    assert sorted(trace) == sorted(got["momentum"])
    for name, w in trace.items():
        err = (np.linalg.norm(got["momentum"][name].numpy() - w)
               / np.linalg.norm(w))
        assert err <= MOMENTUM_NORM_TOL, (name, err)


# ------------------------------------------------------------ in process

def test_make_mesh_rejects_non_divisible():
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(6, model_axis=4)


def _expected_dim(spec, ndim):
    """The port dim of JAX's PartitionSpec: HWIO's O and I are OIHW's 0 and
    1, (in, out)'s out is (out, in)'s 0."""
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return None
    return {4: {3: 0, 2: 1}, 2: {1: 0}}[ndim][axes[0]]


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_model_parallel_spec_matches_jax(arch):
    """Leaf for leaf over every variable of ResNet18Private and
    ResNet50Private with their passport configs: the port shards the
    tensors JAX shards, along the swapped dim."""
    cfg = load_passport_config(str(CONFIGS / f"{arch}_passport.json"))
    kw, _ = construct_passport_kwargs(cfg, "bn", "shuffle", 0.1)
    jmodel = (jax_resnet.ResNet18(num_classes=10, passport_kwargs=kw,
                                  private=True) if arch == "resnet18"
              else jax_resnet.ResNet50Private(num_classes=10,
                                              passport_kwargs=kw))
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.key(0), "passport": jax.random.key(1)}, x,
        train=True), jnp.zeros((1, 32, 32, 3)))
    pmodel = build_model(arch, 10, passport_kwargs=kw, private=True,
                         device="cpu")
    own = pmodel.state_dict()
    seen, sharded = set(), 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(shapes))[0]:
        keys = [str(k.key) for k in path]
        spec = jax_mesh.model_parallel_spec("/".join(keys), leaf.ndim)
        name, _ = _port_entry(keys[0], tuple(keys[1:]),
                              np.broadcast_to(np.float32(0), leaf.shape))
        want = _expected_dim(spec, leaf.ndim)
        assert model_parallel_spec(name, own[name].ndim) == want, name
        seen.add(name)
        sharded += want is not None
    assert seen == set(own)
    assert sharded >= {"resnet18": 5, "resnet50": 20}[arch]


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


@pytest.fixture
def recorder(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    rec = _Recorder()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", rec)
    return rec


def test_noop_without_configuration(recorder):
    assert distributed.maybe_initialize_distributed() is False
    assert recorder.calls == []


def test_env_variables_are_parsed(recorder, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert distributed.maybe_initialize_distributed(backend="gloo") is True
    assert recorder.calls == [((), {"backend": "gloo",
                                    "init_method": "tcp://10.0.0.1:1234",
                                    "world_size": 4, "rank": 2})]


def test_explicit_args_override_env(recorder, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert distributed.maybe_initialize_distributed(
        coordinator_address="10.9.9.9:1", num_processes=8, process_id=7,
        backend="gloo") is True
    assert recorder.calls == [((), {"backend": "gloo",
                                    "init_method": "tcp://10.9.9.9:1",
                                    "world_size": 8, "rank": 7})]


def test_auto_mode_sets_up_a_world_of_one(recorder):
    """JAX's bare ``initialize()`` detects a pod; without torchrun's
    variables the port's auto mode is a world of one process."""
    assert distributed.maybe_initialize_distributed(auto=True,
                                                    backend="gloo") is True
    [(args, kwargs)] = recorder.calls
    assert args == () and isinstance(kwargs.pop("store"), dist.HashStore)
    assert kwargs == {"backend": "gloo", "world_size": 1, "rank": 0}


def _loaders(rng, raw_wm):
    """Two identical sets of loaders (one per package): 35 task images in
    batches of 7, 6 triggers in pairs, shuffled from fixed seeds."""
    x = rng.integers(0, 256, (35, 8, 8, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 35).astype(np.int32)
    wx = rng.integers(0, 256, (6, 8, 8, 3)).astype(np.uint8)
    wy = rng.integers(0, 10, 6).astype(np.int32)
    return [(DataLoader(x, y, 7, shuffle=True, drop_last=True, seed=1,
                        raw=True),
             DataLoader(wx, wy, 2, shuffle=True, drop_last=True, seed=0,
                        raw=raw_wm))
            for _ in range(2)]


@pytest.mark.parametrize("path", ["host", "device_augment"])
def test_batches_pad_to_the_batch_axis_as_jax(path):
    """V3 on the conftest's 8-device mesh: B + 2 = 9 rows padded to 16 with
    weight-0 triggers from the cycling iterator, batch for batch as JAX's
    ``ClassificationExperiment._batches`` pads them."""
    device = path == "device_augment"
    (ptrain, pwm), (jtrain, jwm) = _loaders(np.random.default_rng(0), device)
    port = object.__new__(ClassificationExperiment)
    port.train_data, port.device_augment, port.n_shards = ptrain, device, 8
    port.wm_data, port.wm_data_raw = (None, pwm) if device else (pwm, None)
    ref = object.__new__(JaxExperiment)
    ref.train_data, ref.mesh = jtrain, jax_mesh.make_mesh()
    ref.device_augment = (lambda key, x: x) if device else None
    ref.wm_data, ref.wm_data_raw = (None, jwm) if device else (jwm, None)
    got, want = list(port._batches()), list(ref._batches())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (len(w["label"]) + len(w.get("wm_label", ()))) % 8 == 0
        assert w["weight"].sum() == 9


def test_multihost_world_of_one_changes_no_bit(tmp_path):
    """``--multihost`` without torchrun's variables: a world of one on an
    in-process store, taken down at the end; history.csv (the clock's
    columns aside) and last.ckpt equal the run without it, bit for bit."""
    runs = {}
    for name, extra in (("plain", []), ("multihost", ["--multihost"])):
        exp = train_v23.main(CLI_ARGV + extra + ["--logdir",
                                                 str(tmp_path / name)],
                             device="cpu", **SIZES)
        runs[name] = exp.logdir
    assert not dist.is_initialized()
    plain, multi = (_history(runs[k]) for k in ("plain", "multihost"))
    assert len(plain) == len(multi) == 1
    assert sorted(plain[0]) == sorted(multi[0])
    for k in plain[0]:
        if k not in CLOCK_COLUMNS:
            assert plain[0][k] == multi[0][k], k
    a, b = (torch.load(os.path.join(runs[k], "models", "last.ckpt"),
                       weights_only=True) for k in ("plain", "multihost"))
    assert a["step"] == b["step"] and sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           b["optimizer"]["state"][i]["momentum_buffer"])


# ------------------------------------------------------ launched: 2 ranks

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Two ranks: two split V2 steps of ResNet9 from JAX's weights and
    draws, then one epoch of ``cli.train_v23 --multihost``. Beside them,
    in this process: JAX's steps on a 2-device mesh and the CLI's epoch
    on one process."""
    directory = tmp_path_factory.mktemp("world2")
    jmodel, v = _resnet9_init()
    batches = step_batches()
    inputs = {"resnet9": jax_state_dict(v), "batches": batches,
              "draws": [list(jax_draws(s, BATCH)) for s in range(2)],
              "cli_argv": CLI_ARGV + ["--logdir",
                                      str(directory / "logs_world2")]}
    procs = _launch("world2", 2, directory, inputs)

    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    jstep = jax_train_step(jmodel, True, split_branches=True,
                           device_augment=make_device_augment(PAD))
    jstate = jax_mesh.replicate(JaxTrainState.create(
        jax.tree.map(jnp.asarray, v), jax_sgd(LR)), mesh)
    jmetrics = []
    for batch in batches:
        jstate, jm = jstep(jstate, jax_mesh.shard_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}, mesh))
        jmetrics.append(jax.device_get(jm))
    one = train_v23.main(CLI_ARGV + ["--logdir",
                                     str(directory / "logs_world1")],
                         device="cpu", **SIZES)
    return _finish(procs, directory), jstate, jmetrics, one.logdir


def test_two_rank_split_steps_match_jax_mesh(world2):
    ranks, jstate, jmetrics, _ = world2
    got = ranks[0]["steps"]
    assert got["step"] == 2 and int(jstate.step) == 2
    _assert_step_state(got, jstate, list(zip(jmetrics, got["metrics"])))


def test_two_ranks_hold_bit_equal_states(world2):
    ranks = world2[0]
    for key in ("flat_steps", "flat_cli"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)


def test_two_rank_cli_epoch_matches_one_process(world2):
    """Rank 0 wrote the logdir (expid 1, config.json, history.csv, the
    checkpoints); its epoch is the one-process epoch's, the clock aside, at
    the train-step tolerances."""
    ranks, _, _, one = world2
    logdir = ranks[0]["cli_logdir"]
    assert logdir == ranks[1]["cli_logdir"] and logdir.endswith(
        os.path.join("resnet9_synthetic_v2", "1"))
    for name in ("config.json", os.path.join("models", "last.ckpt"),
                 os.path.join("models", "best.ckpt")):
        assert os.path.exists(os.path.join(logdir, name)), name
    got, want = _history(logdir), _history(one)
    assert len(got) == len(want) == 1 and sorted(got[0]) == sorted(want[0])
    for k, w in want[0].items():
        if k not in CLOCK_COLUMNS:
            np.testing.assert_allclose(float(got[0][k]), float(w),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------ launched: 4 ranks

V3_BATCH, V3_SET, V3_TRIGGERS = 16, 32, 6


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Four ranks: tensor parallelism on a 2x2 mesh, a V3 epoch on a 4x1
    mesh, a fleet of two on a 2x2 mesh, the checkpoints. Beside them, in
    this process: JAX's V3 epoch on a 4-device mesh and JAX's fleet
    sharded over a 4x2 mesh."""
    directory = tmp_path_factory.mktemp("world4")
    rng = np.random.default_rng(11)
    jmodel, v = _resnet9_init()
    images = rng.integers(0, 256, (V3_SET, SIDE, SIDE, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, V3_SET).astype(np.int32)
    wm_images = rng.integers(0, 256, (V3_TRIGGERS, SIDE, SIDE, 3)
                             ).astype(np.uint8)
    wm_labels = rng.integers(0, 10, V3_TRIGGERS).astype(np.int32)
    key = jax.random.key(5)
    steps, perm = jax_epoch_permutation(key, V3_SET, V3_BATCH)
    wm_perm = jax.random.permutation(jax.random.fold_in(key, 1), V3_TRIGGERS)
    jfleet_model, jens = _jax_fleet()
    fleet_batches = [{k: np.asarray(a) for k, a in
                      toy_batch(n=8, size=FLEET_SIDE, seed=s).items()}
                     for s in (0, 1)]
    inputs = {
        "tp_batch": {"image": rng.normal(size=(8, SIDE, SIDE, 3))
                     .astype(np.float32),
                     "label": rng.integers(0, 10, 8).astype(np.int64)},
        "v3": {"state": jax_state_dict(v), "batch_size": V3_BATCH,
               "images": images, "labels": labels, "wm_images": wm_images,
               "wm_labels": wm_labels,
               "perm": np.asarray(perm).reshape(-1).astype(np.int64),
               "wm_perm": np.asarray(wm_perm).astype(np.int64),
               "draws": [list(jax_draws(s, V3_BATCH)) for s in range(steps)]},
        "members": [jax_state_dict(jax.tree.map(
            np.asarray, jax_ens.member_state(jens, i).model_variables()))
            for i in range(2)],
        "fleet_batches": fleet_batches,
        "ckpt_batches": [{"image": rng.normal(size=(16, SIDE, SIDE, 3))
                          .astype(np.float32),
                          "label": rng.integers(0, 10, 16).astype(np.int64)}
                         for _ in range(4)],
    }
    starts = [{k: t.clone() for k, t in m.items()}
              for m in _tensors(inputs["members"])]
    procs = _launch("world4", 4, directory, inputs)

    mesh4 = jax_mesh.make_mesh(jax.devices()[:4])
    fn = jax_epoch_fn(jmodel, True, V3_BATCH, PAD, wm_batch=2, mesh=mesh4)
    jstate = jax_mesh.replicate(JaxTrainState.create(
        jax.tree.map(jnp.asarray, v), jax_sgd(LR)), mesh4)
    jstate, jv3 = fn(jstate, *jax_device_resident(images, labels, mesh4),
                     key, *jax_device_resident(wm_images, wm_labels, mesh4))

    mesh42 = jax_mesh.make_mesh(model_axis=2)
    sharded = jax_ens.shard_ensemble(jens, mesh42, axis_name="model")
    estep = jax_ens.make_ensemble_train_step(jfleet_model, private=True)
    jfleet_metrics = []
    for batch in fleet_batches:
        sb = {k: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(
            mesh42, jax.sharding.PartitionSpec("batch")))
            for k, a in batch.items()}
        sharded, jm = estep(sharded, sb)
        jfleet_metrics.append(jax.device_get(jm))
    return (_finish(procs, directory), (jstate, jax.device_get(jv3)),
            (sharded, jfleet_metrics, starts))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_tensor_parallel_step_matches_replicated(world4, block):
    """A 2x2 mesh: ResNet9 (BasicBlock) and ResNet(Bottleneck, (1, 1, 1,
    1)) with layer3/layer4 kernels and the head sharded over 'model',
    against the replicated step from the same weights, at
    tests/test_train.py's tolerances; the slices keep their shapes."""
    loss_rtol, tol = TP_TOL[block]
    for out in (r[f"tp_{block}"] for r in world4[0]):
        assert out["n_sharded"] >= {"basic": 5, "bottleneck": 8}[block]
        assert out["slice_shapes"] == out["slice_shapes_after"]
        rep, tp = out["replicated"], out["sharded"]
        np.testing.assert_allclose(tp["metrics"]["loss"],
                                   rep["metrics"]["loss"], rtol=loss_rtol)
        for name, want in rep["model"].items():
            np.testing.assert_allclose(tp["model"][name].numpy(),
                                       want.numpy(), err_msg=name, **tol)
        for name, want in rep["momentum"].items():
            np.testing.assert_allclose(tp["momentum"][name].numpy(),
                                       want.numpy(), err_msg=name, **tol)


def test_v3_epoch_with_weight0_padding_matches_jax_mesh_epoch(world4):
    """The V3 epoch on a 4-way batch axis: the trigger pair taken as 4
    (two weight-0 lookaheads), against JAX's mesh epoch with its
    permutations and draws injected."""
    ranks, (jstate, jmetrics), _ = world4
    got = ranks[0]["v3"]
    assert got["step"] == int(jstate.step) == V3_SET // V3_BATCH
    _assert_step_state(got, jstate, [(jmetrics, got["metrics"])])


def test_shard_ensemble_matches_jax_sharded_fleet(world4):
    """Members over 'model', data over 'batch' (2x2 here, JAX's 4x2): each
    member's two steps against JAX's sharded fleet at the port fleet
    test's bounds (tests/test_torch_port_ensemble.py)."""
    ranks, _, (jens, jmetrics, starts) = world4
    seen = set()
    for r in ranks:
        fleet = r["fleet"]
        for j, i in enumerate(fleet["indices"]):
            seen.add(i)
            for jm, pm in zip(jmetrics, fleet["metrics"]):
                for k in jm:
                    np.testing.assert_allclose(
                        pm[k][j], float(np.asarray(jm[k])[i]), err_msg=k,
                        **FLEET_METRIC_TOL)
            member = jax.tree.map(np.asarray, jax_ens.member_state(jens, i))
            want = jax_state_dict({"params": member.params,
                                   "batch_stats": member.batch_stats})
            got = fleet["members"][j]["model"]
            for name, w in want.items():
                update = w - starts[i][name].numpy()
                err = (np.linalg.norm(got[name].numpy() - w)
                       / np.linalg.norm(update))
                assert err <= FLEET_UPDATE_NORM_TOL, (i, name, err)
    assert seen == {0, 1}


def test_multihost_checkpoint_resume_is_bit_exact(world4):
    """The counterpart of tests/multihost_ckpt_worker.py: two steps,
    ``save_state_multihost`` (rank 0 writes, the barrier holds every rank
    until the file is there), ``load_state_multihost`` into a fresh
    template, two more steps: bit for bit the uninterrupted four."""
    for r in world4[0]:
        ckpt = r["ckpt"]
        assert ckpt["written_before_barrier"] and ckpt["restored_step"] == 2
        np.testing.assert_array_equal(ckpt["resumed"], ckpt["baseline"])


def test_model_sharded_state_round_trips(world4):
    """A state sharded over the 2-wide 'model' axis is written whole and
    reads back into an unsharded template bit for bit."""
    for r in world4[0]:
        ckpt = r["ckpt"]
        assert ckpt["tp_sharded"] == 7
        np.testing.assert_array_equal(ckpt["tp"], ckpt["mid"])


def test_dcp_round_trip_is_bit_exact(world4):
    """``save_state_dcp``/``load_state_dcp`` (the Orbax pair's counterpart)
    over four ranks restore the state, momentum and step bit for bit."""
    for r in world4[0]:
        assert r["ckpt"]["dcp_step"] == 2
        np.testing.assert_array_equal(r["ckpt"]["dcp"], r["ckpt"]["mid"])


def test_four_ranks_hold_bit_equal_states(world4):
    ranks = world4[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["v3"]["flat"], ranks[0]["v3"]["flat"])
        for key in ("baseline", "mid", "resumed", "dcp", "tp"):
            np.testing.assert_array_equal(r["ckpt"][key],
                                          ranks[0]["ckpt"][key], err_msg=key)
        for block in ("basic", "bottleneck"):
            for kind in ("replicated", "sharded"):
                a = r[f"tp_{block}"][kind]["model"]
                b = ranks[0][f"tp_{block}"][kind]["model"]
                for name in a:
                    assert torch.equal(a[name], b[name]), (block, kind, name)
    # the ranks of one member's 'batch' group: 0 and 2, 1 and 3
    for a, b in ((0, 2), (1, 3)):
        for ma, mb in zip(ranks[a]["fleet"]["members"],
                          ranks[b]["fleet"]["members"]):
            for name in ma["model"]:
                assert torch.equal(ma["model"][name], mb["model"][name])
