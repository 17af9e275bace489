"""Checkpointing: the full train state in one file.

Counterpart of ``deepipr_tpu/utils/checkpoint.py``. Unlike the reference's
weights-only ``.pth`` (experiments/base.py:139-150), a checkpoint carries the
complete state: the model's ``state_dict`` (parameters, BN running
statistics, passports ``key``/``skey`` and signatures ``b``), the
optimizer's state (momentum) and the step counter. Everything is saved as
CPU tensors with ``torch.save`` and loaded with ``torch.load(...,
weights_only=True)`` (W8): no pickled code runs at load.

Several processes (the JAX module's multi-host half): ``save_state_multihost``
gathers every tensor-parallel slice into its whole tensor on every rank,
rank 0 alone writes, and a barrier holds every rank until the file is on
disk; ``load_state_multihost`` reads the file on every rank and replicates
rank 0's copy. ``save_state_dcp``/``load_state_dcp`` take the place of the
JAX module's Orbax pair: ``torch.distributed.checkpoint`` writes a
directory, each rank its share. Every load is ``weights_only`` and strict
on passports and signatures (W8).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict

import torch

from deepipr_tpu_torch.train.state import TrainState

# state_dict entries a checkpoint must match exactly (W8): a passport or a
# signature silently kept from the template would verify the wrong owner
_STRICT_LEAVES = ("key", "skey", "b")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def snapshot(state: TrainState) -> Dict[str, Any]:
    """The state as a dict of CPU copies: what a checkpoint file holds.
    A tensor-parallel state's slices are gathered into whole tensors
    (parallel/mesh.py), collectively over its 'model' group."""
    model = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    if getattr(state, "model_sharded", None):
        from deepipr_tpu_torch.parallel.mesh import gathered_tensors

        model = gathered_tensors(state, model)
        names = [n for n, _ in state.model.named_parameters()]
        momentum = {names[i]: st["momentum_buffer"]
                    for i, st in optimizer["state"].items()
                    if st.get("momentum_buffer") is not None}
        momentum = gathered_tensors(state, momentum)
        optimizer["state"] = {
            i: {**st, "momentum_buffer": momentum[names[i]]}
            if names[i] in momentum else st
            for i, st in optimizer["state"].items()}
    return _to_cpu({"model": model, "optimizer": optimizer,
                    "step": int(state.step)})


def _write(path: str, snap: Dict[str, Any]) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(snap, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_state(path: str, state: TrainState) -> None:
    """Atomic write: serialize to path.tmp, fsync, rename; a crash mid-save
    never corrupts the previous checkpoint."""
    _write(path, snapshot(state))


def save_model(path: str, model: torch.nn.Module) -> None:
    """The model's ``state_dict`` alone (no optimizer, no step), written as
    ``save_state`` writes: the deployment artifact's format
    (cli/export_deployment.py), read back by ``load_model``."""
    _write(path, _to_cpu({"model": model.state_dict()}))


class AsyncCheckpointer:
    """Overlap the disk write of a checkpoint with the next epoch's work.

    ``save()`` copies the state to the host on the caller's thread (so the
    train step may go on updating it) and hands the write to one worker
    thread. The queue is bounded: a producer faster than the disk blocks
    instead of piling snapshots up. Errors surface at ``flush()``; call it
    before reading checkpoints back or exiting.
    """

    def __init__(self, max_pending: int = 3):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            path, snap = self._q.get()
            try:
                _write(path, snap)
            except BaseException as e:  # surfaced on the next flush()
                self._error = e
            finally:
                self._q.task_done()

    def save(self, path: str, state: TrainState) -> None:
        self._q.put((path, snapshot(state)))

    def flush(self) -> None:
        """Block until all queued saves are on disk; re-raise any error."""
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e


@torch.no_grad()
def load_model_entries(model: torch.nn.Module,
                       entries: Dict[str, torch.Tensor], source: str,
                       caller: str) -> None:
    """Fill ``model`` (in place, on its device) from state-dict
    ``entries``. An unmatched passport or signature entry raises, and so do
    an entry the model has and ``entries`` lack and a shape mismatch;
    entries the model lacks are dropped with a loud warning, as the JAX
    package does. ``source`` names the entries in an error, ``caller`` the
    loader in the warning."""
    own = model.state_dict()
    missing = sorted(set(own) - set(entries))
    dropped = sorted(set(entries) - set(own))
    strict = [k for k in missing + dropped
              if k.rsplit(".", 1)[-1] in _STRICT_LEAVES]
    if strict:
        raise ValueError(f"{source}: passport or signature entries do not "
                         f"match the model: {strict}")
    if missing:
        raise ValueError(f"{source} lacks model entries {missing}")
    shapes = [f"{k} {tuple(entries[k].shape)} vs {tuple(v.shape)}"
              for k, v in own.items() if entries[k].shape != v.shape]
    if shapes:
        raise ValueError(f"{source}: shapes do not match the model: "
                         f"{shapes}")
    if dropped:
        print(f"WARNING: {caller} dropped {len(dropped)} checkpoint "
              f"entr{'y' if len(dropped) == 1 else 'ies'} not in the "
              f"template: {dropped[:6]}{' ...' if len(dropped) > 6 else ''}")
    model.load_state_dict({k: entries[k] for k in own}, strict=True)


def has_separate_stats(path: str) -> bool:
    """Whether a port checkpoint carries per-branch BN statistics
    ('bn_private'), read from its state-dict names."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return any(".bn_private." in k for k in data["model"])


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore the model entries of a checkpoint (``save_state``'s or
    ``save_model``'s) into ``model``, in place, as ``load_state`` does with
    restore_opt=False, and return it."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    load_model_entries(model, data["model"], f"checkpoint {path}",
                       "load_model")
    return model


def load_state(path: str, template: TrainState,
               restore_opt: bool = True) -> TrainState:
    """Restore a checkpoint into ``template`` (in place, on the template's
    device) and return it.

    ``restore_opt=False`` keeps the template's optimizer state and step
    counter: the "load pretrained weights" semantics of ``--pretrained-path``
    and the attack tools. The model entries must match the template's
    (``load_model_entries``).
    """
    data = torch.load(path, map_location="cpu", weights_only=True)
    load_model_entries(template.model, data["model"], f"checkpoint {path}",
                       "load_state")
    if restore_opt:
        template.optimizer.load_state_dict(data["optimizer"])
        template.step = int(data["step"])
    return template


# --------------------------------------------------------------------------
# several processes
# --------------------------------------------------------------------------

def _process_group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def save_state_multihost(path: str, state: TrainState) -> None:
    """Rank 0 writes the checkpoint; collective: every rank calls it.

    Counterpart of the JAX module's ``save_state_multihost``. Every rank
    takes the snapshot (a tensor-parallel state's slices are gathered into
    whole tensors, a collective over its 'model' group), rank 0 alone
    writes it with ``save_state``'s atomic write, and a barrier keeps every
    rank from reading the file before it is there. With one process it is
    ``save_state``."""
    if _process_group_size() == 1:
        save_state(path, state)
        return
    import torch.distributed as dist

    snap = snapshot(state)
    if dist.get_rank() == 0:
        _write(path, snap)
    dist.barrier()


def load_state_multihost(path: str, template: TrainState, mesh=None,
                         restore_opt: bool = True) -> TrainState:
    """Every rank reads the checkpoint into ``template`` (``load_state``),
    then, with a mesh, ``replicate``s rank 0's copy; a tensor-parallel
    caller shards the result afterwards (``shard_model_parallel``). The
    template must be unsharded. Counterpart of the JAX module's
    ``load_state_multihost``."""
    state = load_state(path, template, restore_opt=restore_opt)
    if mesh is not None:
        from deepipr_tpu_torch.parallel.mesh import replicate

        state = replicate(state, mesh)
    return state


def _dcp_entries(snap: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    """A snapshot as the flat, name-keyed tensor dict the directory
    checkpoint holds: 'model/<entry>', 'momentum/<parameter>', 'step'."""
    out = {f"model/{k}": v for k, v in snap["model"].items()}
    for i, st in snap["optimizer"]["state"].items():
        if st.get("momentum_buffer") is not None:
            out[f"momentum/{names[i]}"] = st["momentum_buffer"]
    out["step"] = torch.tensor(snap["step"], dtype=torch.int64)
    return out


def save_state_dcp(directory: str, state: TrainState) -> None:
    """Write the state as a ``torch.distributed.checkpoint`` directory: the
    counterpart of the JAX module's ``save_state_orbax``. Collective in a
    process group (every rank calls it; replicated entries are written
    once); a tensor-parallel state is gathered first, as
    ``save_state_multihost`` does."""
    import torch.distributed.checkpoint as dcp

    names = [n for n, _ in state.model.named_parameters()]
    dcp.save(_dcp_entries(snapshot(state), names),
             checkpoint_id=os.path.abspath(directory),
             no_dist=_process_group_size() == 1)


def load_state_dcp(directory: str, template: TrainState,
                   restore_opt: bool = True) -> TrainState:
    """Read a ``save_state_dcp`` directory into ``template`` (unsharded; in
    place, on its device) and return it: the counterpart of the JAX
    module's ``load_state_orbax``. The model entries are held to the template as
    ``load_state`` holds them (W8); ``restore_opt`` restores the momentum
    and the step counter."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    meta = dcp.FileSystemReader(directory).read_metadata()
    entries = {}
    for key, md in meta.state_dict_metadata.items():
        if not hasattr(md, "size"):
            raise ValueError(f"checkpoint {directory}: {key} is not a tensor")
        entries[key] = torch.empty(tuple(md.size),
                                   dtype=md.properties.dtype)
    dcp.load(entries, checkpoint_id=directory,
             no_dist=_process_group_size() == 1)
    model = {k[len("model/"):]: v for k, v in entries.items()
             if k.startswith("model/")}
    load_model_entries(template.model, model, f"checkpoint {directory}",
                       "load_state_dcp")
    if restore_opt:
        params = dict(template.model.named_parameters())
        momentum = {k[len("momentum/"):]: v for k, v in entries.items()
                    if k.startswith("momentum/")}
        unknown = sorted(set(momentum) - set(params))
        if unknown:
            raise ValueError(f"checkpoint {directory}: momentum of "
                             f"parameters the model lacks: {unknown}")
        template.optimizer.state.clear()
        with torch.no_grad():
            for name, buf in momentum.items():
                p = params[name]
                template.optimizer.state[p] = {
                    "momentum_buffer": buf.to(p.device).clone()}
        template.step = int(entries["step"])
    return template
