"""Attack 3 — ambiguity attack: optimize fake passports
(reference passport_attack_3.py).

Counterpart of ``deepipr_tpu/attacks/ambiguity.py``. The attacker freezes all
model weights, replaces the passports with trainable copies (original + 0.001
noise), optionally flips a fraction of the signature bits, and trains ONLY
the fake passports with

    CE + sign loss + coef * sum(1 / MSE(orig, fake))

(the "maximize distance" term; ``coef`` is 2.0 in the JAX package and 1 in
the original reference, W4), clipping the fake-passport gradient to global
norm 2 (passport_attack_3.py:60-74). The fake passports and the flipped
signature are tensors handed to ``functional_call`` in eval mode, so on the
card every passport block runs kernel K2 forward and K2-bwd backward
(ops/passport_epilogue.py). Passport and signature dicts are keyed by
buffer name (``layer4_0.convbnrelu_1.key``, ``....b``); sums over them run
in the order ``jax.tree.leaves`` takes the JAX trees (``tree_order``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from deepipr_tpu_torch.attacks.common import tree_order
from deepipr_tpu_torch.data.device_augment import draw_augment, scaled_stats
from deepipr_tpu_torch.ops.fused_augment import fused_augment
from deepipr_tpu_torch.passport.sign_loss import total_sign_loss
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.epoch import device_resident, epoch_permutation
from deepipr_tpu_torch.train.steps import (
    collect_aux,
    cross_entropy_mean,
    top1_accuracy,
)
from deepipr_tpu_torch.utils.device import (
    model_device,
    nhwc_to_nchw,
    seeded_generator,
)
from deepipr_tpu_torch.utils.mode import eval_mode

Tensors = Dict[str, torch.Tensor]
MAXIMIZE_COEF = 2.0  # the JAX package's coefficient (ambiguity.py:84), W4
CLIP_NORM = 2.0


def signatures(model) -> Tensors:
    """The model's signature buffers by name (``layer4_0.convbnrelu_1.b``)."""
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] == "b"}


def flip_signature_bits(signature: Mapping[str, torch.Tensor], perc: float,
                        seed: int) -> Tensors:
    """Flip `perc` of each layer's signature bits (chosen per layer without
    replacement, passport_attack_3.py:245-263), with the JAX package's NumPy
    draws, layer by layer in its tree order."""
    if perc == 0:
        return dict(signature)
    rng = np.random.default_rng(seed)
    out = {}
    for name in tree_order(signature):
        t = signature[name]
        b = t.detach().cpu().numpy().copy()
        k = int(b.size * perc)
        idx = rng.choice(b.size, k, replace=False)
        b.reshape(-1)[idx] *= -1
        out[name] = torch.from_numpy(b).to(t.device)
    return out


def passport_distances(orig: Mapping[str, torch.Tensor],
                       fake: Mapping[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum 1/MSE, sum MSE, sum cosine) over all passport leaves."""
    maximize = mse_total = cs_total = 0.0
    for name in tree_order(orig):
        o, f = orig[name], fake[name]
        mse = torch.mean((o - f) ** 2)
        mse_total = mse_total + mse
        maximize = maximize + 1.0 / (mse + 1e-12)
        of, ff = o.reshape(-1), f.reshape(-1)
        cs = torch.sum(of * ff) / (torch.linalg.norm(of)
                                   * torch.linalg.norm(ff) + 1e-12)
        cs_total = cs_total + cs
    return maximize, mse_total, cs_total


def ambiguity_loss(model, signature: Mapping[str, torch.Tensor],
                   private: bool, fake: Mapping[str, torch.Tensor],
                   orig: Mapping[str, torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor, coef: float = MAXIMIZE_COEF):
    """(loss, metrics) of the NCHW batch ``x`` under the fake passports and
    ``signature``, in eval mode: the JAX step's ``loss_fn``. Differentiable
    with respect to the fake passports."""
    kwargs = {"ind": 1} if private else {}
    with eval_mode(model):
        out = functional_call(model, {**signature, **fake}, (x,), kwargs)
    ce = cross_entropy_mean(out.logits, y)
    sl, sacc = total_sign_loss(collect_aux(out.aux), x.device)
    maximize, mse_total, cs_total = passport_distances(orig, fake)
    loss = ce + sl + coef * maximize
    metrics = {
        "loss": ce, "signloss": sl, "signacc": sacc,
        "maximizeloss": maximize, "mseloss": mse_total,
        "csloss": cs_total, "acc": top1_accuracy(out.logits, y),
    }
    return loss, metrics


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float = CLIP_NORM) -> List[torch.Tensor]:
    """optax's clip_by_global_norm: each g * max_norm / ||g|| where the
    global norm ||g|| (summed in the order given) is at least max_norm,
    else g (not ``clip_grad_norm_``'s max_norm / (||g|| + 1e-6))."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = g_norm >= max_norm
    return [torch.where(clip, g / g_norm * max_norm, g) for g in grads]


class PassportOptimizer:
    """optax.chain(clip_by_global_norm(2), add_decayed_weights(5e-4),
    trace(0.9), scale_by_learning_rate(lr)) over the fake passports."""

    def __init__(self, leaves: Mapping[str, torch.Tensor], lr: float,
                 max_norm: float = CLIP_NORM, decay: float = 5e-4,
                 momentum: float = 0.9):
        self.lr, self.max_norm = lr, max_norm
        self.decay, self.momentum = decay, momentum
        self.trace = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        names = tree_order(leaves)
        clipped = clip_by_global_norm([grads[k] for k in names],
                                      self.max_norm)
        for k, g in zip(names, clipped):
            g = g + self.decay * leaves[k]
            self.trace[k] = g + self.momentum * self.trace[k]
            leaves[k].add_(-self.lr * self.trace[k])


def make_ambiguity_step(model, signature: Mapping[str, torch.Tensor],
                        private: bool, optimizer: PassportOptimizer,
                        coef: float = MAXIMIZE_COEF):
    """step(fake, orig, x, y) -> metrics: one update of the fake passports
    (leaves that require a gradient, updated in place) on the NCHW batch."""

    def step(fake: Tensors, orig: Tensors, x: torch.Tensor, y: torch.Tensor):
        loss, metrics = ambiguity_loss(model, signature, private, fake, orig,
                                       x, y, coef)
        names = tree_order(fake)
        grads = torch.autograd.grad(loss, [fake[k] for k in names])
        optimizer.step(fake, dict(zip(names, grads)))
        return {k: v.detach() for k, v in metrics.items()}

    return step


def initial_fakes(orig: Mapping[str, torch.Tensor], noise_std: float,
                  seed: int, noise: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Tensors:
    """orig + noise_std * N(0, 1), as leaves that require a gradient. The
    JAX package draws the noise from ``jax.random``; ``noise`` (by name,
    unit normal) replaces the port's draws, as the tests inject JAX's."""
    gen = torch.Generator().manual_seed(seed)
    fake = {}
    for name in tree_order(orig):
        o = orig[name].detach()
        z = (torch.randn(o.shape, generator=gen) if noise is None
             else torch.as_tensor(noise[name], dtype=torch.float32))
        fake[name] = (o + noise_std * z.to(o.device)).requires_grad_(True)
    return fake


def ambiguity_attack(
    model,
    train_data,
    valid_data,
    epochs: int,
    private: bool,
    flipperc: float = 0.0,
    lr: float = 0.01,
    seed: int = 0,
    noise_std: float = 0.001,
    eval_fn: Optional[Callable[[Tensors], Dict]] = None,
    scan_epochs: bool = False,
    coef: float = MAXIMIZE_COEF,
    noise: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Tensors, List[Dict]]:
    """Run the full ambiguity attack; returns (fake_passports, history).

    ``model`` holds the attacked weights and is not modified. ``noise``:
    injected unit-normal draws (``initial_fakes``).

    scan_epochs=True runs each attack epoch on the device-resident set (the
    train/epoch.py pattern): the loader's uint8 images parked on the device
    once, a permutation per epoch, and kernel K1 (ops/fused_augment.py)
    gathering, cropping, flipping and normalizing each batch, with one host
    read of the epoch's mean metrics. The JAX package runs that epoch as
    one lax.scan; the optimization is the same, only the augmentation
    draws differ from the host loader's."""
    dev = model_device(model)
    orig = {k: v.detach().clone() for k, v in passports(model).items()}
    fake = initial_fakes(orig, noise_std, seed, noise)
    signature = flip_signature_bits(signatures(model), flipperc, seed + 1)
    optimizer = PassportOptimizer(fake, lr)
    step = make_ambiguity_step(model, signature, private, optimizer, coef)

    resident = None
    if scan_epochs and getattr(train_data, "images", None) is not None:
        size = train_data.images.shape[1]
        pad = int((4 / 32) * size) if train_data.random_crop else 0
        resident = device_resident(train_data.images, train_data.labels, dev)
        mean255, std255 = scaled_stats(device=dev)

    history: List[Dict] = []
    for ep in range(1, epochs + 1):
        sums, nb = None, 0
        if resident is not None:
            xs, ys = resident
            perm = torch.randperm(
                xs.shape[0], generator=seeded_generator(dev, seed + 50, ep),
                device=dev)
            steps, rows = epoch_permutation(perm, train_data.batch_size)
            for t in range(steps):
                idx = rows[t].to(torch.int32)
                draws = draw_augment(seeded_generator(dev, seed + 50, ep, t),
                                     idx.shape[0], pad)
                x = fused_augment(xs, idx, *draws, mean255, std255, pad)
                metrics = step(fake, orig, x, ys[idx.long()])
                sums = metrics if sums is None else {
                    k: sums[k] + metrics[k] for k in sums}
                nb += 1
        else:
            for batch in train_data:
                x = nhwc_to_nchw(batch["image"], dev)
                y = torch.as_tensor(batch["label"], device=dev).long()
                metrics = step(fake, orig, x, y)
                sums = metrics if sums is None else {
                    k: sums[k] + metrics[k] for k in sums}
                nb += 1
        names = list(sums)
        values = torch.stack([sums[k].float() for k in names]).tolist()
        row = {f"train_{k}": v / nb for k, v in zip(names, values)}
        row["epoch"] = ep
        row["flipperc"] = flipperc
        with torch.no_grad():
            _, mse_total, cs_total = passport_distances(orig, fake)
        nleaves = len(orig)
        row["cosine_similarity"] = float(cs_total) / max(nleaves, 1)
        row["mse"] = float(mse_total) / max(nleaves, 1)
        if eval_fn is not None:
            row.update(eval_fn({k: v.detach() for k, v in fake.items()}))
        history.append(row)
    return {k: v.detach() for k, v in fake.items()}, history
