"""Licensee fleets: N passport models of one architecture, each with its own
passports and signature, trained together on one stream of batches.

Counterpart of ``deepipr_tpu/train/ensemble.py`` (the DeepIPR deployment
story, reference README.md:40-61: a distinct passport and signature per
licensee). The JAX package stacks the member states into one pytree and
advances them with one ``jit(vmap(train_step))``. The port's model holds its
weights, and its train step updates the BN running statistics and the SGD
state in place (ops/norms.py, train/state.py::apply_gradients), which
``torch.func.vmap`` over stacked modules cannot carry without rewriting the
step. So an ensemble here is a list of N member ``TrainState``s, and a
fleet step advances each member in turn on the one shared batch: the
arithmetic of JAX's ``vmap(train_step)``, member by member. Metrics are
per-member vectors, as there. Eval forwards (signature rows, dual eval)
run member by member too: K2's ctypes launch cannot be batched by ``vmap``.

``shard_ensemble`` (members over a mesh axis) waits for DDP (ROADMAP
queue 1, item 1). The members' random draws are the port's own (W7):
``init_ensemble`` seeds each member's ``build_model`` from (seed, i), and
``override_signature`` seeds a ``torch.Generator`` from the JAX package's
per-layer digest, so a signature's ASCII head equals JAX's and its random
tail does not; tests inject JAX's members.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepipr_tpu_torch.attacks.common import derived_affines, jax_path
from deepipr_tpu_torch.data.device_augment import make_device_augment
from deepipr_tpu_torch.passport.codec import (
    SignatureSpec,
    bit_accuracy,
    encode_signature,
)
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.epoch import epoch_permutation
from deepipr_tpu_torch.train.keys import (
    collect_taps,
    passport_layers,
    passports_from_taps,
)
from deepipr_tpu_torch.train.schedule import Schedule
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import DrawFn, make_train_step, \
    seeded_draws
from deepipr_tpu_torch.utils.device import (
    DeviceLike,
    require_on_device,
    resolve_device,
    seeded_generator,
)

Ensemble = List[TrainState]  # one model each


def stack_states(states: Sequence[TrainState]) -> Ensemble:
    """N member TrainStates as one ensemble. The members must share the
    architecture (the same state-dict names and shapes), and each must hold
    a model of its own."""
    if not states:
        raise ValueError("need at least one member state")
    shapes = {k: v.shape for k, v in states[0].model.state_dict().items()}
    for i, s in enumerate(states[1:], start=1):
        if {k: v.shape for k, v in s.model.state_dict().items()} != shapes:
            raise ValueError(f"member {i} has another architecture than "
                             "member 0")
    if len({id(s.model) for s in states}) != len(states):
        raise ValueError("two members share one model")
    return list(states)


def member_state(ensemble: Ensemble, i: int) -> TrainState:
    """Member i: its TrainState (for eval, export, checkpointing one
    licensee's model)."""
    return ensemble[i]


def ensemble_size(ensemble: Ensemble) -> int:
    return len(ensemble)


def signature_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's signature buffers by name (``layer4_0.convbn_2.b``)."""
    layers = set(passport_layers(model))
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[0] in layers
            and name.rsplit(".", 1)[-1] == "b"}


def override_signature(signature: Mapping[str, torch.Tensor],
                       spec: SignatureSpec, seed: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """Re-encode every layer's ``b`` (keyed as ``signature_buffers``) with
    ``spec``: a str puts its ASCII bits in the leading channels, an int a
    constant, None random signs (reference passportconv2d.py:25-41). Each
    layer's generator is seeded from the JAX package's digest of
    ``f"{seed}:{path}"`` with the layer's JAX path, so same-named layers in
    different blocks (layer4_0/convbn_2, layer4_1/convbn_2) keep
    independent random tails. The ASCII head is JAX's; the tail is the
    port's own (W7)."""
    out = {}
    for name, b in signature.items():
        path = jax_path(name.rsplit(".", 1)[0])
        digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
        gen = torch.Generator().manual_seed(
            int.from_bytes(digest[:4], "little"))
        out[name] = encode_signature(gen, b.shape[-1], spec)
    return out


def member_seed(seed: int, i: int) -> int:
    """Member i's model seed: a function of (seed, i) alone, the
    counterpart of ``fold_in(key(seed), i)``."""
    digest = hashlib.blake2b(repr((seed, i)).encode(), digest_size=4)
    return int.from_bytes(digest.digest(), "little") >> 1


@torch.no_grad()
def init_ensemble(make_model: Callable[[int], nn.Module],
                  learning_rate: Schedule, n: int, seed: int = 0,
                  signatures: Optional[Sequence[SignatureSpec]] = None,
                  ) -> Ensemble:
    """N members with independent weights, passports and signatures:
    member i's model is ``make_model(member_seed(seed, i))`` (e.g. a
    ``build_model`` with that seed), under SGD at ``learning_rate``.

    ``signatures``: one spec per member (say an ASCII string per
    licensee), written into every passport layer of that member with
    ``override_signature(..., seed=seed * n + i)``; by default each member
    keeps its config's or random signature.
    """
    if signatures is not None and len(signatures) != n:
        raise ValueError(f"got {len(signatures)} signatures for {n} members")
    members = []
    for i in range(n):
        model = make_model(member_seed(seed, i))
        if signatures is not None:
            own = signature_buffers(model)
            if not own:
                raise ValueError(
                    "signatures given but the model has no passport layers "
                    "(no signature buffers) — nothing to embed them in")
            for name, b in override_signature(own, signatures[i],
                                              seed=seed * n + i).items():
                own[name].copy_(b)
        members.append(TrainState.create(model, learning_rate))
    return stack_states(members)


@torch.no_grad()
def setup_ensemble_passports(ensemble: Ensemble, pretrained_model: nn.Module,
                             key_x: np.ndarray,
                             key_y: Optional[np.ndarray] = None,
                             seed: int = 0) -> Ensemble:
    """Give each member its own passports: the key setup (train/keys.py)
    with selection seed ``seed * max(n, 1) + i`` for member i, so every
    licensee's scale and bias derive from different secret activation
    shuffles. The pretrained model's tap forwards run once; only the
    selection differs. ``key_x``/``key_y``: NHWC candidates for the bias
    and the scale passports. Members are updated in place."""
    n = ensemble_size(ensemble)
    taps_x = collect_taps(pretrained_model, key_x)
    taps_y = taps_x if key_y is None else collect_taps(pretrained_model,
                                                        key_y)
    for i, state in enumerate(ensemble):
        own = passports(state.model)
        new = passports_from_taps(taps_x, taps_y,
                                  passport_layers(state.model),
                                  seed=seed * max(n, 1) + i)
        if set(new) != set(own):
            raise ValueError(f"key setup made {sorted(new)}, member {i} has "
                             f"{sorted(own)}")
        for name, value in new.items():
            own[name].copy_(value)
    return ensemble


def _stack(metrics):
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_ensemble_train_step(ensemble: Ensemble, private: bool,
                             per_member_data: bool = False, **step_kwargs):
    """The fleet's train step: ``make_train_step`` (with ``step_kwargs``)
    for each member's model, run member by member.

    per_member_data=False feeds every member the same batch; True expects
    batch leaves with a leading member axis (bootstrap resamples or
    per-licensee data). Returns step(ensemble, batch) -> (ensemble,
    metrics), every metric an (N,) device tensor; the members are updated
    in place.
    """
    steps = [make_train_step(s.model, private, **step_kwargs)
             for s in ensemble]

    def step(ens: Ensemble, batch):
        if len(ens) != len(steps):
            raise ValueError(f"step built for {len(steps)} members, got "
                             f"{len(ens)}")
        metrics = []
        for i, (fn, state) in enumerate(zip(steps, ens)):
            b = {k: v[i] for k, v in batch.items()} if per_member_data \
                else batch
            metrics.append(fn(state, b)[1])
        return ens, _stack(metrics)

    return step


def make_ensemble_epoch_fn(ensemble: Ensemble, private: bool,
                           batch_size: int, pad: int,
                           seed: int = 0, draws: Optional[DrawFn] = None,
                           device: DeviceLike = "cuda"):
    """Device-resident epochs for the whole fleet: epoch_fn(ensemble,
    images_u8, labels, epoch_key, perm=None) -> (ensemble, mean_metrics).

    All members see one shuffled order (``torch.randperm`` from a generator
    seeded by ``epoch_key``, or ``perm``) and one augmentation per step:
    the batch is augmented once, by the plain device stage of
    data/device_augment.py (the JAX fleet epoch augments with its XLA stage
    ``make_device_augment``, not the Pallas one), with draws keyed off
    member 0's step counter (members in lockstep: each member's own), from
    ``draws(step, n)``, by default ``seeded_draws(seed, pad, device)``;
    tests inject JAX's. Then every member takes its train step on it, so
    the fleet pays one augmentation, not N. Pad 0 degrades to flip and
    normalize. ``mean_metrics``: each metric's mean
    over the steps, an (N,) device tensor. V2 scope, as in JAX.
    """
    dev = resolve_device(device)
    augment = make_device_augment(pad)
    draws = draws or seeded_draws(seed, pad, dev)
    fleet_step = make_ensemble_train_step(ensemble, private, device=dev)

    def epoch_fn(ens: Ensemble, images_u8: torch.Tensor,
                 labels: torch.Tensor, epoch_key: int,
                 perm: Optional[torch.Tensor] = None):
        n = images_u8.shape[0]
        if perm is None:
            perm = torch.randperm(
                n, generator=seeded_generator(dev, epoch_key), device=dev)
        steps, rows = epoch_permutation(torch.as_tensor(perm, device=dev),
                                        batch_size)
        history = []
        for t in range(steps):
            idx = rows[t].long()
            oy, ox, flip = draws(ens[0].step, batch_size)
            x = augment((torch.as_tensor(oy, device=dev),
                         torch.as_tensor(ox, device=dev),
                         torch.as_tensor(flip, device=dev)), images_u8[idx])
            # an NHWC view of the NCHW batch: the step's NCHW copy of it
            # is this tensor again
            ens, metrics = fleet_step(ens, {"image": x.permute(0, 2, 3, 1),
                                            "label": labels[idx]})
            history.append(metrics)
        return ens, {k: v.mean(dim=0) for k, v in _stack(history).items()}

    return epoch_fn


def make_ensemble_signature_fn(input_shape, private: bool,
                               device: DeviceLike = "cuda"):
    """fn(ensemble) -> {layer path: (N,) f32 array of detection rates},
    one derivation (a forward of the passport branch: K2 on the card) per
    member."""
    dev = resolve_device(device)

    def fn(ens: Ensemble) -> Dict[str, np.ndarray]:
        rows: Dict[str, list] = {}
        for state in ens:
            require_on_device(state.model, dev)
            for path, aux in derived_affines(state.model, input_shape,
                                             private).items():
                rows.setdefault(path, []).append(
                    bit_accuracy(aux["scale"], aux["b"]))
        return {path: torch.stack(v).cpu().numpy()
                for path, v in rows.items()}

    return fn
