"""The (batch, model) mesh of ranks, data and tensor parallelism.

Counterpart of ``deepipr_tpu/parallel/mesh.py``. The JAX package lays its
devices on a ``("batch", "model")`` mesh; inputs are sharded over 'batch',
the state is replicated, and XLA's SPMD partitioner makes the step's
collectives. Here the mesh is a ``torch.distributed`` ``DeviceMesh`` of
ranks in the same layout (rank ``r`` sits at ``(r // model, r % model)``),
and the collectives are explicit. Every one of them is an ``all_reduce``, a
``broadcast`` or a ``barrier``: the only collectives ``gloo`` offers on CUDA
tensors, and so the only way to run several ranks on one card.

- ``shard_batch``/``batch_rows``: this rank's contiguous rows of the global
  batch, in ``P("batch")``'s order: every rank sees the same global batch
  and keeps its rows.
- ``replicate``: rank 0's parameters, buffers and momentum on every rank.
- ``all_reduce_gradients``: one coalesced sum of every gradient over the
  'batch' group (train/steps.py calls it after ``backward()``).
- Tensor parallelism over 'model' (``model_parallel_spec``,
  ``shard_model_parallel``): each rank keeps one slice of the wide
  layer3/layer4 conv kernels and of the dense heads, with their momentum.
  The train step gathers the slices into whole weights for the forward
  (``gather_model_parallel``: each rank broadcasts its slices over the
  'model' group, so the gather is exact), and the gather's backward hands
  each slice its part of the gradient. The ranks of one 'model' group hold
  the same rows, so they make the same whole gradient; after the 'batch'
  sum each slice's update is the replicated step's update of that slice,
  to the bit.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepipr_tpu_torch.train.state import TrainState

AXES = ("batch", "model")

# residual units whose conv kernels are sharded over 'model': layer3 and
# layer4 carry about 3/4 of a ResNet's weights (JAX mesh.py:122-125)
TP_UNITS = ("layer3_", "layer4_")


def make_mesh(world: Optional[int] = None, batch_axis: int = -1,
              model_axis: int = 1):
    """A ``DeviceMesh`` of ``world`` ranks (default: the process group's)
    with dims ("batch", "model"); ``batch_axis=-1`` takes ``world //
    model_axis``. A world that does not make the mesh raises ValueError,
    as the JAX package's does, before the process group is consulted."""
    n = world if world is not None else dist.get_world_size()
    if batch_axis == -1:
        batch_axis = n // model_axis
    if batch_axis * model_axis != n:
        raise ValueError(
            f"make_mesh: {n} devices cannot form a ({batch_axis} batch x "
            f"{model_axis} model) mesh; pass a device count divisible by "
            f"model_axis={model_axis}")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(f"make_mesh: the process group has "
                         f"{dist.get_world_size() if dist.is_initialized() else 0}"
                         f" ranks, the mesh {n}")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (batch_axis, model_axis),
                            mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def batch_rows(n: int, mesh) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a global batch of ``n``; raises
    unless the 'batch' axis divides ``n``."""
    shards = axis_size(mesh, "batch")
    if n % shards:
        raise ValueError(f"a global batch of {n} does not split over a "
                         f"{shards}-way batch axis")
    per = n // shards
    lo = axis_index(mesh, "batch") * per
    return lo, lo + per


def shard_batch(batch: Mapping, mesh) -> Dict:
    """This rank's rows of every array of ``batch`` (NumPy or tensors,
    leading dim the global batch)."""
    out = {}
    for k, v in batch.items():
        lo, hi = batch_rows(len(v), mesh)
        out[k] = v[lo:hi]
    return out


def _tensors(state: TrainState) -> List[torch.Tensor]:
    """Parameters, buffers and momentum buffers, in an order every rank
    shares."""
    out = [p.data for p in state.model.parameters()]
    out += list(state.model.buffers())
    for p in state.model.parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out.append(buf)
    return out


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` on one flat buffer per dtype and device
    holding ``tensors``, and copy the result back into them."""
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, piece in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def replicate(state: TrainState, mesh) -> TrainState:
    """Rank 0's parameters, BN statistics, passports, signatures and
    momentum on every rank (in place); returns ``state``."""
    if mesh.size() > 1:
        _coalesced(_tensors(state), lambda flat: dist.broadcast(flat, src=0))
    return state


def all_reduce_gradients(params: Sequence[torch.Tensor], mesh,
                         extra: Optional[torch.Tensor] = None
                         ) -> Optional[torch.Tensor]:
    """Sum every parameter's ``.grad`` over the 'batch' group in one
    all-reduce, with ``extra`` (a flat f32 vector, the step's metric
    sums) riding in the same buffer; returns the summed ``extra``."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + ([extra.reshape(-1)] if extra is not None else []))
    dist.all_reduce(flat, group=axis_group(mesh, "batch"))
    sizes = [g.numel() for g in grads]
    pieces = torch.split(flat, sizes + ([extra.numel()]
                                        if extra is not None else []))
    with torch.no_grad():
        for g, piece in zip(grads, pieces):
            g.copy_(piece.view_as(g))
    return pieces[-1] if extra is not None else None


# --------------------------------------------------------------------------
# tensor parallelism over the 'model' axis
# --------------------------------------------------------------------------

def model_parallel_spec(name: str, ndim: int) -> Optional[int]:
    """The dim of the port tensor ``name`` (a state-dict name) sharded
    over 'model', or None for a replicated one: JAX's choice
    (``model_parallel_spec``, mesh.py:128-160) in the port's layouts.

    - layer3/layer4 ``convbnrelu_1`` conv kernels: output channels, dim 0
      of OIHW (JAX: the O of HWIO), column-parallel;
    - every other conv kernel of those units (``convbn_2``,
      ``convbnrelu_2``, ``convbn_3``, ``shortcut``): input channels, dim 1
      (JAX: the I), row-parallel;
    - the ``linear``/``classifier*`` dense kernels: output features, dim 0
      of (out, in) (JAX: the out of (in, out));
    - everything else (BN vectors, biases, passports, signatures, the
      other convs): replicated.
    """
    if (ndim == 4 and any(u in name for u in TP_UNITS)
            and name.endswith(".conv.weight")):
        return 0 if ".convbnrelu_1." in name else 1
    parts = name.split(".")
    if (ndim == 2 and len(parts) >= 2 and parts[-1] == "weight"
            and parts[-2].startswith(("linear", "classifier"))):
        return 0
    return None


def _shard(t: torch.Tensor, dim: int, index: int, parts: int
           ) -> torch.Tensor:
    if t.shape[dim] % parts:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not "
                         f"split {parts} ways")
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone()


@torch.no_grad()
def shard_model_parallel(state: TrainState, mesh) -> TrainState:
    """Keep only this rank's slice of each parameter that
    ``model_parallel_spec`` shards, and of its momentum buffer, in place;
    the state records the sharded names (``state.model_sharded``, name ->
    dim) and the mesh. The model's own forward then no longer runs: the
    train step (``make_train_step(..., mesh=mesh)``) gathers the slices,
    and ``utils/checkpoint.py::save_state_multihost`` writes whole
    tensors."""
    parts, index = axis_size(mesh, "model"), axis_index(mesh, "model")
    for name, p in state.model.named_parameters():
        dim = model_parallel_spec(name, p.ndim)
        if dim is None or name in state.model_sharded:
            continue
        p.data = _shard(p.data, dim, index, parts)
        if p.grad is not None:
            p.grad = torch.zeros_like(p.data)
        opt = state.optimizer.state.get(p, {})
        if opt.get("momentum_buffer") is not None:
            opt["momentum_buffer"] = _shard(opt["momentum_buffer"], dim,
                                            index, parts)
        state.model_sharded[name] = dim
    state.mesh = mesh
    return state


def count_model_sharded(state: TrainState) -> int:
    """Parameters of ``state`` sharded over the 'model' axis (JAX counts
    the sharded leaves of ``state.params``)."""
    return len(state.model_sharded)


def _gather(slices: Sequence[torch.Tensor], dims: Sequence[int], mesh
            ) -> List[torch.Tensor]:
    """Whole tensors from every 'model' rank's ``slices``: each rank in
    turn broadcasts its slices as one flat buffer, and the pieces are
    joined along their dims; bitwise exact."""
    group = axis_group(mesh, "model")
    ranks = dist.get_process_group_ranks(group)
    me = axis_index(mesh, "model")
    own = torch.cat([s.detach().reshape(-1) for s in slices])
    pieces = []
    for j, src in enumerate(ranks):
        buf = own if j == me else torch.empty_like(own)
        dist.broadcast(buf, src=src, group=group)
        pieces.append(torch.split(buf, [s.numel() for s in slices]))
    return [torch.cat([piece[i].view_as(s) for piece in pieces], dim=d)
            for i, (s, d) in enumerate(zip(slices, dims))]


class _GatherModelParallel(torch.autograd.Function):
    """Forward: the whole weights from the ranks' slices. Backward: each
    slice's part of its whole weight's gradient (the 'model' ranks make
    the same whole gradient, so nothing is summed over 'model')."""

    @staticmethod
    def forward(ctx, mesh, dims, *slices):
        ctx.dims = dims
        ctx.index = axis_index(mesh, "model")
        ctx.sizes = [s.shape[d] for s, d in zip(slices, dims)]
        return tuple(_gather(slices, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        out = [None if g is None else
               g.narrow(d, ctx.index * size, size).contiguous()
               for g, d, size in zip(grads, ctx.dims, ctx.sizes)]
        return (None, None, *out)


def gather_model_parallel(state: TrainState) -> Dict[str, torch.Tensor]:
    """{name: whole tensor} of the state's sharded parameters, differentiable
    back to the slices, for ``torch.func.functional_call``; {} for a state
    with none sharded."""
    if not getattr(state, "model_sharded", None):
        return {}
    params = dict(state.model.named_parameters())
    names = sorted(state.model_sharded)
    if axis_size(state.mesh, "model") == 1:
        return {n: params[n] for n in names}
    whole = _GatherModelParallel.apply(
        state.mesh, [state.model_sharded[n] for n in names],
        *[params[n] for n in names])
    return dict(zip(names, whole))


@torch.no_grad()
def gathered_tensors(state: TrainState, tensors: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``tensors`` (keyed by parameter name, the sharded ones slices) with
    each sharded entry replaced by its whole tensor; collective over the
    'model' group."""
    names = sorted(n for n in tensors if n in state.model_sharded)
    if not names or axis_size(state.mesh, "model") == 1:
        return dict(tensors)
    whole = _gather([tensors[n] for n in names],
                    [state.model_sharded[n] for n in names], state.mesh)
    return {**tensors, **dict(zip(names, whole))}


def flat_state(state: TrainState) -> np.ndarray:
    """Every parameter, buffer and momentum entry of an unsharded state as
    one f32 vector: what the ranks compare for bitwise equality."""
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in _tensors(state)]).numpy()
