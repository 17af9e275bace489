"""The port's licensee fleets (train/ensemble.py, cli/train_ensemble.py)
against the JAX package's ``train/ensemble.py`` on the CPU.

The cases of tests/test_ensemble.py that need no mesh, on its model (AlexNet
V2 at 32 px, passports on features_4-6). The members are JAX's
``init_ensemble`` draws, loaded into the port with ``load_jax_variables``,
and the augmentation draws and epoch permutation are JAX's, handed to the
port (W7). Both sides run on the CPU: JAX at 'highest' matmul precision
(tests/conftest.py), the port through its kernels' plain versions.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepipr_tpu import serve as jax_serve
from deepipr_tpu.attacks.common import derived_affines as jax_derived_affines
from deepipr_tpu.data.datasets import load_cifar as jax_load_cifar
from deepipr_tpu.models import AlexNet as JaxAlexNet
from deepipr_tpu.train import ensemble as jax_ens
from deepipr_tpu.train import keys as jax_keys
from deepipr_tpu.train.epoch import epoch_permutation as jax_epoch_permutation
from deepipr_tpu.train.schedule import sgd_optimizer as jax_sgd
from deepipr_tpu.train.state import TrainState as JaxTrainState

from deepipr_tpu_torch.cli import train_ensemble, verify_ownership
from deepipr_tpu_torch.interop.jax_params import (
    export_jax_variables,
    jax_state_dict,
    load_jax_variables,
)
from deepipr_tpu_torch.models.registry import build_model
from deepipr_tpu_torch.passport.codec import decode_string
from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.data.datasets import load_cifar
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.serve import verify_ownership as verify_port_ownership
from deepipr_tpu_torch.train.ensemble import (
    ensemble_size,
    init_ensemble,
    make_ensemble_epoch_fn,
    make_ensemble_signature_fn,
    make_ensemble_train_step,
    member_seed,
    member_state,
    override_signature,
    setup_ensemble_passports,
    signature_buffers,
    stack_states,
)
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import make_train_step
from deepipr_tpu_torch.utils.config import construct_passport_kwargs

from test_torch_port_experiment import PASSPORT_TOL
from test_torch_port_train import MOMENTUM_NORM_TOL, PAD, jax_draws
from test_train import tiny_passport_model, toy_batch

# AlexNet at CIFAR's 32 px: the port maps JAX's flattened classifier rows
# for a 4x4 map (interop/jax_params.py)
SIDE, LR, SEED = 32, 0.01, 7
SHAPE = (1, SIDE, SIDE, 3)
CFG = {"0": False, "2": False, "4": True, "5": True, "6": True}
# Metrics at tests/test_torch_port_train.py's bound. Each member's update of
# each parameter and BN statistic norm-wise, at the bound that file holds
# the momentum (the summed gradients) to: a pre-ReLU value within float32
# noise of zero lands on opposite sides in XLA and ATen and moves whole
# gradients. The fleet's first step is driven by the sign loss of a random
# signature (about 8.7 against a CE of 19 at JAX's init), and the second
# step amplifies its rounding: measured worst over the two members, step 1
# 4.2e-3 of an update's norm, step 2 4.1e-2 (member 0, features_0's
# kernel), where one BN running mean lies 1.3e-3 from JAX's (2.1e-6 after
# step 1), beyond the train tests' elementwise rtol 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
UPDATE_NORM_TOL = MOMENTUM_NORM_TOL


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kwargs():
    kw, _ = construct_passport_kwargs(CFG, "bn", "shuffle", 0.1)
    return kw


def _port_model(private=True, seed=0):
    return build_model("alexnet", 10, passport_kwargs=_kwargs(),
                       private=private, input_size=SIDE, seed=seed,
                       device="cpu")


def _member(seed):
    return _port_model(seed=seed)


_FLEETS = {}


def _jax_fleet(private=True):
    """tests/test_ensemble.py's fleet of two (JAX's init_ensemble, seed 7),
    initialised once per scheme; fresh arrays on every call, since JAX's
    fleet steps donate theirs."""
    model = tiny_passport_model(private=private)
    if private not in _FLEETS:
        _FLEETS[private] = jax.tree.map(np.asarray, jax_ens.init_ensemble(
            model, jax_sgd(LR), (2, SIDE, SIDE, 3), n=2, seed=SEED))
    return model, jax.tree.map(jnp.asarray, _FLEETS[private])


def _port_fleet(jens, private=True):
    """The port's fleet on the JAX members' weights (W7: JAX's draws)."""
    members = []
    for i in range(jax_ens.ensemble_size(jens)):
        v = jax.tree.map(np.asarray,
                         jax_ens.member_state(jens, i).model_variables())
        model = _port_model(private)
        load_jax_variables(model, v)
        members.append(TrainState.create(model, LR))
    return stack_states(members)


def _host(batch):
    return {k: np.array(v) for k, v in batch.items()}


def _trained(ens):
    """Each member's parameters and BN statistics (what a step changes), as
    numpy copies by state-dict name."""
    return [{k: v.detach().numpy().copy()
             for k, v in member_state(ens, i).model.state_dict().items()
             if k.rsplit(".", 1)[-1] not in ("key", "skey", "b")}
            for i in range(ensemble_size(ens))]


def _assert_members_match(jens, pens, start):
    """Each member's update of each parameter and BN statistic (from
    ``start``, the equal weights both fleets began with) within
    UPDATE_NORM_TOL of the norm of JAX's update. Returns the worst."""
    worst = 0.0
    for i, (got, before) in enumerate(zip(_trained(pens), start)):
        js = jax.tree.map(np.asarray, jax_ens.member_state(jens, i))
        want = jax_state_dict({"params": js.params,
                               "batch_stats": js.batch_stats})
        assert sorted(want) == sorted(got)
        for name, w in want.items():
            upd = w - before[name]
            assert np.linalg.norm(upd) > 0, (i, name)
            err = np.linalg.norm(got[name] - w) / np.linalg.norm(upd)
            worst = max(worst, err)
            assert err <= UPDATE_NORM_TOL, (i, name, err)
    return worst


def _assert_metrics_match(pm, jm, n=2):
    assert sorted(pm) == sorted(jm)
    for k in jm:
        assert tuple(pm[k].shape) == (n,), k
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **METRIC_TOL)


# -------------------------------------------------------------- stacking

def test_init_shapes_and_member_roundtrip():
    ens = init_ensemble(_member, LR, n=3, seed=SEED)
    assert ensemble_size(ens) == 3
    # independent members: each model seeded from (seed, i) alone (W7)
    k = [member_state(ens, i).model.features_4.conv.weight for i in range(3)]
    assert not torch.allclose(k[0], k[1]) and not torch.allclose(k[1], k[2])
    again = init_ensemble(_member, LR, n=3, seed=SEED)
    assert torch.equal(member_state(again, 1).model.features_4.conv.weight,
                       k[1])
    assert len({member_seed(SEED, i) for i in range(3)}
               | {member_seed(SEED + 1, 0)}) == 4
    re = stack_states([member_state(ens, i) for i in range(3)])
    assert all(member_state(re, i) is member_state(ens, i) for i in range(3))


def test_errors():
    with pytest.raises(ValueError, match="at least one"):
        stack_states([])
    with pytest.raises(ValueError, match="no passport layers"):
        init_ensemble(lambda s: build_model("alexnet", 10, input_size=SIDE,
                                            seed=s, device="cpu"),
                      LR, n=2, signatures=["a", "b"])
    with pytest.raises(ValueError, match="signatures"):
        init_ensemble(_member, LR, n=3, signatures=["a", "b"])
    one = TrainState.create(_port_model(), LR)
    with pytest.raises(ValueError, match="share one model"):
        stack_states([one, one])
    with pytest.raises(ValueError, match="architecture"):
        stack_states([one, TrainState.create(_port_model(private=False),
                                             LR)])


# ------------------------------------------------------- steps vs JAX

@pytest.fixture(scope="module")
def stepped():
    """JAX's fleet and the port's on its weights, after two fleet steps on
    the same batches; the metrics of each step and both fleets' signature
    rows before the steps."""
    jmodel, jens = _jax_fleet()
    pens = _port_fleet(jens)
    start = _trained(pens)
    rows = (jax_ens.make_ensemble_signature_fn(jmodel, SHAPE, True)(jens),
            make_ensemble_signature_fn(SHAPE, True, device="cpu")(pens))
    jstep = jax_ens.make_ensemble_train_step(jmodel, private=True)
    pstep = make_ensemble_train_step(pens, True, device="cpu")
    metrics = []
    for seed in (0, 1):
        batch = toy_batch(n=8, size=SIDE, seed=seed)
        jens, jm = jstep(jens, batch)
        pens, pm = pstep(pens, _host(batch))
        metrics.append((jm, pm))
    return jmodel, jens, pens, metrics, rows, start


def test_two_fleet_steps_match_jax(stepped):
    _, jens, pens, metrics, _, start = stepped
    for jm, pm in metrics:
        _assert_metrics_match(pm, jm)
    assert [s.step for s in pens] == [2, 2]
    _assert_members_match(jens, pens, start)


def test_signature_rows_match_jax(stepped):
    """{layer: per-member detection} on equal weights: JAX's members before
    the steps, and the port's members after them, read back into a JAX
    fleet (``export_jax_variables``)."""
    jmodel, _, pens, _, (jbefore, pbefore), _ = stepped
    tx = jax_sgd(LR)
    back = jax_ens.stack_states([JaxTrainState.create(
        jax.tree.map(jnp.asarray, export_jax_variables(s.model)), tx)
        for s in pens])
    jafter = jax_ens.make_ensemble_signature_fn(jmodel, SHAPE, True)(back)
    pafter = make_ensemble_signature_fn(SHAPE, True, device="cpu")(pens)
    for want, got in ((jbefore, pbefore), (jafter, pafter)):
        assert sorted(got) == sorted(want) == ["features_4", "features_5",
                                               "features_6"]
        for path in want:
            assert got[path].shape == (2,)
            np.testing.assert_array_equal(got[path], np.asarray(want[path]))


def test_fleet_step_equals_independent_member_steps():
    """A fleet step is each member's own train step, bit for bit, V1 and
    V2 (the port's counterpart of JAX's vmap-equals-loop check)."""
    for private in (True, False):
        _, jens = _jax_fleet(private=private)
        fleet, singles = _port_fleet(jens, private), _port_fleet(jens, private)
        step = make_ensemble_train_step(fleet, private, device="cpu")
        batch = _host(toy_batch(n=8, size=SIDE))
        for _ in range(2):
            fleet, em = step(fleet, batch)
        for i, s in enumerate(singles):
            one = make_train_step(s.model, private, device="cpu")
            for _ in range(2):
                s, sm = one(s, batch)
            for k, v in sm.items():
                assert float(em[k][i]) == float(v), (private, i, k)
            for (name, a), b in zip(member_state(fleet, i).model
                                    .state_dict().items(),
                                    s.model.state_dict().values()):
                assert torch.equal(a, b), (private, i, name)


def test_per_member_data_matches_jax():
    jmodel, jens = _jax_fleet()
    pens = _port_fleet(jens)
    start = _trained(pens)
    b0, b1 = (toy_batch(n=8, size=SIDE, seed=seed) for seed in (0, 1))
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), b0, b1)
    jstep = jax_ens.make_ensemble_train_step(jmodel, private=True,
                                             per_member_data=True)
    pstep = make_ensemble_train_step(pens, True, per_member_data=True,
                                     device="cpu")
    jens, jm = jstep(jens, stacked)
    pens, pm = pstep(pens, _host(stacked))
    _assert_metrics_match(pm, jm)
    assert float(pm["loss"][0]) != float(pm["loss"][1])
    _assert_members_match(jens, pens, start)


def test_fleet_epoch_matches_jax():
    """One device-resident fleet epoch (two steps) with JAX's permutation
    and augmentation draws injected: per-member mean metrics and the
    members after it."""
    jmodel, jens = _jax_fleet()
    pens = _port_fleet(jens)
    start = _trained(pens)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, SIDE, SIDE, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 32).astype(np.int32)
    bs, key = 16, jax.random.key(11)
    _, rows = jax_epoch_permutation(key, len(x), bs)

    jepoch = jax_ens.make_ensemble_epoch_fn(jmodel, True, bs, PAD)
    jens, jm = jepoch(jens, jnp.asarray(x), jnp.asarray(y), key)
    pepoch = make_ensemble_epoch_fn(pens, True, bs, PAD, draws=jax_draws,
                                    device="cpu")
    pens, pm = pepoch(pens, torch.from_numpy(x), torch.from_numpy(y).long(),
                      0, perm=torch.from_numpy(np.array(rows).reshape(-1)))
    _assert_metrics_match(pm, jm)
    assert [s.step for s in pens] == [2, 2]
    _assert_members_match(jens, pens, start)


# ------------------------------------------------ passports, signatures

@pytest.fixture(scope="module")
def licensees():
    """JAX's fleet and the port's on its weights, each given per-member
    passports by its own setup_ensemble_passports from one pretrained
    AlexNet (JAX's init, loaded into the port) and the same key images."""
    model, jens = _jax_fleet()
    pre = JaxAlexNet(num_classes=10)
    pv = jax.tree.map(np.asarray, pre.init(
        {"params": jax.random.key(9)}, jnp.zeros((2, SIDE, SIDE, 3)),
        train=True))
    ppre = build_model("alexnet", 10, input_size=SIDE, device="cpu")
    load_jax_variables(ppre, pv)
    imgs = np.random.default_rng(0).standard_normal(
        (20, SIDE, SIDE, 3)).astype(np.float32)
    pens = _port_fleet(jens)
    pens = setup_ensemble_passports(pens, ppre, imgs, imgs, seed=5)
    jens = jax_ens.setup_ensemble_passports(model, jens, pre, pv, imgs, imgs,
                                            seed=5)
    return model, jens, pens, ppre, imgs


def test_setup_ensemble_passports_matches_jax(licensees):
    """Per-member passports from one pretrained model's taps: the
    selection of member i (seed * n + i) bit for bit with JAX's selection
    of the same taps, and within PASSPORT_TOL of JAX's whole setup (its
    taps summed in another order)."""
    _, jens, pens, ppre, imgs = licensees

    from deepipr_tpu_torch.train.keys import collect_taps
    taps = {k.replace(".", "/"): v.transpose(0, 2, 3, 1)
            for k, v in collect_taps(ppre, imgs).items()}
    got = [{k: v.numpy() for k, v in passports(s.model).items()}
           for s in pens]
    for i in range(2):
        jpass = jax.tree.map(np.asarray,
                             jax_ens.member_state(jens, i).passport)
        same_taps = jax_state_dict({"passport": jax.tree.map(
            np.asarray, jax_keys.passports_from_taps(taps, taps, jpass,
                                                     seed=5 * 2 + i))})
        whole = jax_state_dict({"passport": jpass})
        assert sorted(got[i]) == sorted(same_taps) == sorted(whole)
        for name in whole:
            np.testing.assert_array_equal(got[i][name], same_taps[name],
                                          err_msg=name)
            np.testing.assert_allclose(got[i][name], whole[name],
                                       err_msg=name, **PASSPORT_TOL)
    assert not np.allclose(got[0]["features_4.key"], got[1]["features_4.key"])


def test_claimed_licensee_passports_match_jax(licensees):
    """Member 1's passports claimed on member 0, each member's signature
    set to the signs its own passports derive (a member trained to
    detection 1.0): the port's per-layer detection equals JAX's on the
    same fleet, and both read well above a random claim's 0.5, because a
    licensee's passports are another shuffle of the same non-negative
    pretrained activations."""
    model, jens, pens, _, _ = licensees
    members = []
    for i in range(2):
        js = jax_ens.member_state(jens, i)
        sig = jax.tree.map(np.asarray, js.signature)
        own = signature_buffers(pens[i].model)
        for path, aux in jax_derived_affines(model, js.model_variables(),
                                             SHAPE, True).items():
            b = np.where(np.asarray(aux["scale"]) >= 0, 1.0,
                         -1.0).astype(np.float32)
            node = sig
            for part in path.split("/"):
                node = node[part]
            node["b"] = b
            own[path.replace("/", ".") + ".b"].copy_(torch.from_numpy(b))
        members.append(js.replace(signature=jax.tree.map(jnp.asarray, sig)))

    owner = jax_serve.verify_ownership(model, members[0], SHAPE, True)
    assert owner["verified"], owner
    assert verify_port_ownership(pens[0].model, SHAPE, True,
                                 device="cpu")["verified"]
    want = jax_serve.verify_ownership(
        model, members[0], SHAPE, True, claimed_passports=members[1].passport)
    got = verify_port_ownership(
        pens[0].model, SHAPE, True,
        claimed_passports=passports(pens[1].model), device="cpu")
    assert got["layers"] == want["layers"]
    assert not want["verified"] and not got["verified"]
    assert all(0.7 < r < 1.0 for r in want["layers"].values()), want


def test_override_signature_head_matches_jax():
    """The ASCII head equals JAX's; the tail is ±1, a function of (seed,
    layer path) alone (W7: not JAX's bits)."""
    model = _port_model()
    own = {k: v.clone() for k, v in signature_buffers(model).items()}
    assert sorted(own) == [f"features_{i}.b" for i in (4, 5, 6)]
    jsig = {f"features_{i}": {"b": jnp.ones(v.shape)}
            for i, v in ((4, own["features_4.b"]), (5, own["features_5.b"]),
                         (6, own["features_6.b"]))}
    want = jax_ens.override_signature(jsig, "Hi", seed=3)
    got = override_signature(own, "Hi", seed=3)
    for i in (4, 5, 6):
        g, w = got[f"features_{i}.b"].numpy(), np.asarray(
            want[f"features_{i}"]["b"])
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:16], w[:16])  # 'Hi' = 16 bits
        assert set(np.unique(g[16:])) <= {-1.0, 1.0}
        assert decode_string(got[f"features_{i}.b"], 2) == "Hi"
    again = override_signature(own, "Hi", seed=3)
    other = override_signature(own, "Hi", seed=4)
    assert all(torch.equal(again[k], got[k]) for k in got)
    assert any(not torch.equal(other[k][16:], got[k][16:]) for k in got)


def test_same_named_nested_layers_get_independent_tails():
    sig = {"layer4_0.convbn_2.b": torch.ones(512),
           "layer4_1.convbn_2.b": torch.ones(512)}
    out = override_signature(sig, "Hi", seed=0)
    b0, b1 = out["layer4_0.convbn_2.b"], out["layer4_1.convbn_2.b"]
    assert torch.equal(b0[:16], b1[:16])
    assert not torch.equal(b0[16:], b1[16:])
    jout = jax_ens.override_signature(
        {"layer4_0": {"convbn_2": {"b": jnp.ones(512)}}}, "Hi", seed=0)
    np.testing.assert_array_equal(
        b0[:16].numpy(), np.asarray(jout["layer4_0"]["convbn_2"]["b"])[:16])


# ------------------------------------------------------------------ CLI

def test_cli_members_verify(tmp_path, capsys):
    """cli.train_ensemble on the CPU, then each member checkpoint through
    cli.verify_ownership: decoded per its signature string, member 0's
    commitment holding for member 0 and not for member 1."""
    out = str(tmp_path / "fleet")
    config = "passport_configs/alexnet_passport.json"
    run = train_ensemble.main(
        ["--arch", "alexnet", "--members", "2", "--signatures", "Al,Bo",
         "--epochs", "1", "--batch-size", "32", "--epoch-scan",
         "--passport-config", config, "--out", out],
        device="cpu", synthetic_train=64, synthetic_test=32)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("Epoch   1 m0[loss=")
    assert "m1[" in printed[0]
    assert printed[1].startswith("member 0: sig='Al' acc_public=")
    assert len(run["epochs"]) == 1 and run["epochs"][0]["loss"].shape == (2,)
    paths = [m["path"] for m in run["members"]]
    assert paths == [f"{out}/member_0.ckpt", f"{out}/member_1.ckpt"]
    rec = str(tmp_path / "rec.json")
    common = ["--arch", "alexnet", "--passport-config", config]
    rows = make_ensemble_signature_fn((1, 32, 32, 3), True, device="cpu")(
        run["ensemble"])
    for i, text in enumerate(("Al", "Bo")):
        model = member_state(run["ensemble"], i).model
        assert all(decode_string(b, 2) == text
                   for b in signature_buffers(model).values())
        res = verify_ownership.main(
            common + ["--ckpt", paths[i], "--num-chars", "2", "--commit",
                      rec], device="cpu")
        assert res["layers"] == {p: float(r[i]) for p, r in rows.items()}
        assert res["decoded"] == {
            p: decode_string(a["scale"], 2)
            for p, a in derived_affines(model, (1, 32, 32, 3), True).items()}
        assert json.load(open(rec))["commitment"] == res["commitment"]
    # member 1's record is the last written: member 0 does not match it
    res = verify_ownership.main(common + ["--ckpt", paths[0],
                                          "--check-commitment", rec],
                                device="cpu")
    assert res["commitment_valid"] is False and res["verified"] is False


def test_cli_reads_cifar_under_data_root(tmp_path):
    """--dataset cifar10 reads <data-root>/cifar-10-batches-py, the path
    tools/train_ensemble.py reads: a tiny pickled CIFAR-10 there loads as
    JAX's load_cifar loads it and trains one fleet epoch."""
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(3)
    # 8 images a train batch, 24 test images (the key setup samples 20)
    for name, n in [(f"data_batch_{i}", 8) for i in range(1, 6)] + [
            ("test_batch", 24)]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    for got, want in zip(load_cifar(str(tmp_path), "cifar10"),
                         jax_load_cifar(str(tmp_path), "cifar10")):
        np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "fleet")
    run = train_ensemble.main(
        ["--arch", "alexnet", "--dataset", "cifar10", "--data-root",
         str(tmp_path), "--members", "2", "--epochs", "1", "--batch-size",
         "32", "--passport-config", "passport_configs/alexnet_passport.json",
         "--out", out], device="cpu")
    assert len(run["epochs"]) == 1 and run["epochs"][0]["loss"].shape == (2,)
    assert all(os.path.isfile(m["path"]) for m in run["members"])
