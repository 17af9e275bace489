"""One rank of a launched multi-process run of the port on the CPU.

Launched by tests/test_torch_port_parallel.py, one process per rank, over
``gloo`` with a ``file://`` rendezvous:

    python tests/torch_port_parallel_worker.py <task> <rank> <world> <store> <dir>

``<dir>/inputs.pt`` holds what the test hands every rank (JAX's weights as
port state dicts, batches, draws, permutations); the rank writes its
results to ``<dir>/rank<rank>.pt``. Tasks: ``world2`` (two split V2 steps
on a 2-rank mesh, then one epoch of ``cli.train_v23 --multihost``) and
``world4`` (tensor parallelism on a 2x2 mesh, a V3 epoch on a 4-way batch
axis, a ``shard_ensemble`` fleet, and the multi-process checkpoints). The
module imports no JAX, and each rank runs on one intra-op thread.
"""

import copy
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD, LR, SIDE = 2, 0.01, 16
RESNET9_CONFIG = os.path.join(REPO, "passport_configs", "resnet9_passport.json")
ALEXNET_CFG = {"0": False, "2": False, "4": True, "5": True, "6": True}


def resnet9(state=None, seed=0):
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import (
        construct_passport_kwargs,
        load_passport_config,
    )

    kw, _ = construct_passport_kwargs(load_passport_config(RESNET9_CONFIG),
                                      "bn", "random", 0.1)
    model = build_model("resnet9", 10, passport_kwargs=kw, private=True,
                        input_size=SIDE, seed=seed, device="cpu")
    if state is not None:
        model.load_state_dict(state)
    return model


def small_bottleneck(seed=0):
    """ResNet(Bottleneck, (1, 1, 1, 1)) at 16x16 with layer4 flagged."""
    from deepipr_tpu_torch.models.resnet import Bottleneck, ResNet
    from deepipr_tpu_torch.utils.config import construct_passport_kwargs

    cfg = {"convbnrelu_1": False}
    for li in range(1, 5):
        cfg[f"layer{li}"] = {"0": {s: li == 4 for s in (
            "convbnrelu_1", "convbnrelu_2", "convbn_3", "shortcut")}}
    kw, _ = construct_passport_kwargs(cfg, "bn", "random", 0.1)
    return ResNet(Bottleneck, (1, 1, 1, 1), num_classes=10,
                  passport_kwargs=kw, private=True, input_size=SIDE,
                  seed=seed)


def alexnet(state):
    from deepipr_tpu_torch.models.registry import build_model
    from deepipr_tpu_torch.utils.config import construct_passport_kwargs

    kw, _ = construct_passport_kwargs(ALEXNET_CFG, "bn", "shuffle", 0.1)
    model = build_model("alexnet", 10, passport_kwargs=kw, private=True,
                        input_size=32, device="cpu")
    model.load_state_dict(state)
    return model


def trained(state):
    """What a step changes and the test compares: the model's state dict
    and the momentum by parameter name, as CPU copies."""
    from deepipr_tpu_torch.utils.checkpoint import snapshot

    snap = snapshot(state)
    names = [n for n, _ in state.model.named_parameters()]
    momentum = {names[i]: st["momentum_buffer"]
                for i, st in snap["optimizer"]["state"].items()}
    return {"model": snap["model"], "momentum": momentum,
            "step": snap["step"]}


def floats(metrics):
    return {k: v.tolist() for k, v in metrics.items()}


def world2(inputs, out_dir):
    from deepipr_tpu_torch.cli import train_v23
    from deepipr_tpu_torch.parallel.mesh import flat_state, make_mesh
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    result = {}
    mesh = make_mesh()
    model = resnet9(inputs["resnet9"])
    draws = inputs["draws"]
    step = make_train_step(model, True, pad=PAD, device="cpu", mesh=mesh,
                           draws=lambda s, n: draws[s])
    state = TrainState.create(model, LR)
    metrics = []
    for batch in inputs["batches"]:
        state, m = step(state, batch)
        metrics.append(floats(m))
    result["steps"] = {**trained(state), "metrics": metrics}
    result["flat_steps"] = flat_state(state)

    exp = train_v23.main(inputs["cli_argv"] + ["--multihost"], device="cpu",
                         synthetic_train=64, synthetic_test=32)
    result["flat_cli"] = flat_state(exp.state)
    result["cli_logdir"] = exp.logdir
    return result


def tensor_parallel(inputs, make_model):
    """One step of the replicated state and one of the model-sharded state
    on a 2x2 mesh, from equal weights and the same batch."""
    from deepipr_tpu_torch.parallel.mesh import (
        count_model_sharded,
        make_mesh,
        shard_model_parallel,
    )
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step

    mesh = make_mesh(model_axis=2)
    model = make_model(seed=5)
    out = {}
    for kind in ("replicated", "sharded"):
        m = copy.deepcopy(model)
        state = TrainState.create(m, LR)
        if kind == "sharded":
            shard_model_parallel(state, mesh)
            out["n_sharded"] = count_model_sharded(state)
            out["slice_shapes"] = {n: list(p.shape)
                                   for n, p in m.named_parameters()
                                   if n in state.model_sharded}
        step = make_train_step(m, True, device="cpu", mesh=mesh)
        state, metrics = step(state, inputs["tp_batch"])
        out[kind] = {**trained(state), "metrics": floats(metrics)}
        if kind == "sharded":
            out["slice_shapes_after"] = {
                n: list(p.shape) for n, p in m.named_parameters()
                if n in state.model_sharded}
    return out


def v3_epoch(inputs):
    from deepipr_tpu_torch.parallel.mesh import flat_state, make_mesh
    from deepipr_tpu_torch.train.epoch import (
        device_resident,
        make_epoch_train_fn,
    )
    from deepipr_tpu_torch.train.state import TrainState

    v3 = inputs["v3"]
    model = resnet9(v3["state"])
    draws = v3["draws"]
    fn = make_epoch_train_fn(model, True, v3["batch_size"], PAD, wm_batch=2,
                             draws=lambda s, n: draws[s], device="cpu",
                             mesh=make_mesh())
    state = TrainState.create(model, LR)
    images, labels = device_resident(v3["images"], v3["labels"], "cpu")
    wm = device_resident(v3["wm_images"], v3["wm_labels"], "cpu")
    state, metrics = fn(state, images, labels, 0, *wm, perm=v3["perm"],
                        wm_perm=v3["wm_perm"])
    return {**trained(state), "metrics": floats(metrics),
            "flat": flat_state(state)}


def fleet(inputs):
    from deepipr_tpu_torch.parallel.mesh import make_mesh
    from deepipr_tpu_torch.train.ensemble import (
        make_ensemble_train_step,
        member_indices,
        shard_ensemble,
        stack_states,
    )
    from deepipr_tpu_torch.train.state import TrainState

    mesh = make_mesh(model_axis=2)
    ens = stack_states([TrainState.create(alexnet(s), LR)
                        for s in inputs["members"]])
    local = shard_ensemble(ens, mesh)
    step = make_ensemble_train_step(local, True, device="cpu", mesh=mesh)
    metrics = []
    for batch in inputs["fleet_batches"]:
        local, m = step(local, batch)
        metrics.append(floats(m))
    return {"indices": member_indices(len(ens), mesh), "metrics": metrics,
            "members": [trained(s) for s in local]}


def checkpoints(inputs, out_dir):
    """The counterpart of tests/multihost_ckpt_worker.py: interrupt, save,
    resume; a model-sharded state's round trip; a dcp round trip."""
    from deepipr_tpu_torch.parallel.mesh import (
        flat_state,
        make_mesh,
        shard_model_parallel,
    )
    from deepipr_tpu_torch.train.state import TrainState
    from deepipr_tpu_torch.train.steps import make_train_step
    from deepipr_tpu_torch.utils.checkpoint import (
        load_state_dcp,
        load_state_multihost,
        save_state_dcp,
        save_state_multihost,
    )

    dp, tp = make_mesh(), make_mesh(model_axis=2)
    batches = inputs["ckpt_batches"]

    def fresh():
        return TrainState.create(resnet9(seed=3), LR)

    def run(state, lo, hi):
        step = make_train_step(state.model, True, device="cpu", mesh=dp)
        for i in range(lo, hi):
            state, _ = step(state, batches[i])
        return state

    out = {"baseline": flat_state(run(fresh(), 0, 4))}
    mid = run(fresh(), 0, 2)
    out["mid"] = flat_state(mid)
    path = os.path.join(out_dir, "mid.ckpt")
    save_state_multihost(path, mid)
    out["written_before_barrier"] = os.path.exists(path)
    restored = load_state_multihost(path, fresh(), mesh=dp)
    out["restored_step"] = restored.step
    out["resumed"] = flat_state(run(restored, 2, 4))

    save_state_dcp(os.path.join(out_dir, "dcp"), mid)
    back = load_state_dcp(os.path.join(out_dir, "dcp"), fresh())
    out["dcp"] = flat_state(back)
    out["dcp_step"] = back.step

    sharded = shard_model_parallel(mid, tp)
    tp_path = os.path.join(out_dir, "tp.ckpt")
    save_state_multihost(tp_path, sharded)
    out["tp_sharded"] = len(sharded.model_sharded)
    out["tp"] = flat_state(load_state_multihost(tp_path, fresh(), mesh=dp))
    return out


def world4(inputs, out_dir):
    return {"tp_basic": tensor_parallel(inputs, resnet9),
            "tp_bottleneck": tensor_parallel(inputs, small_bottleneck),
            "v3": v3_epoch(inputs), "fleet": fleet(inputs),
            "ckpt": checkpoints(inputs, out_dir)}


def main():
    task, rank, world, store, out_dir = sys.argv[1:6]
    torch.set_num_threads(1)
    from deepipr_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    assert maybe_initialize_distributed(f"file://{store}", int(world),
                                        int(rank), backend="gloo")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=True)
    result = {"world2": world2, "world4": world4}[task](inputs, out_dir)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print("RANK-OK", rank, flush=True)


if __name__ == "__main__":
    main()
