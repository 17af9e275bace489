"""Passport forgery against the DEPLOYED model — a beyond-reference attack.

Counterpart of ``deepipr_tpu/attacks/forge.py`` (its docstring has the
threat model and the JAX package's measurements). The attacker holds only the
deployed V2 model — conv kernels, BN stats, and the public branch's learned
scale/bias — and NO passports. They forge fresh passports from scratch such
that the derived private-branch affines reproduce the public affines, except
on a chosen fraction of channels whose signs are flipped to embed the
ATTACKER's signature. No training data is needed: the loss is a regression
on the derived affines themselves. ``refine_with_data`` is the data-assisted
escalation.

The derived affines are differentiated with respect to the forged passports
through the eval-mode private forward (``attacks/common.py::derive``): on
the card each passport block runs kernel K2 forward and K2-bwd backward,
the regression's gradient reaching K2-bwd as the gradients of K2's scale
and bias outputs. Passport dicts are keyed by buffer name; affines, targets
and the attacker's signature by JAX module path, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from deepipr_tpu_torch.attacks.ambiguity import clip_by_global_norm
from deepipr_tpu_torch.attacks.common import derive, tree_order, zeros_input
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.steps import cross_entropy_mean
from deepipr_tpu_torch.utils.device import model_device, nhwc_to_nchw
from deepipr_tpu_torch.utils.mode import eval_mode

Tensors = Dict[str, torch.Tensor]


def forge_targets(
    model, input_shape, flipperc: float, seed: int, private: bool = True,
) -> Tuple[Dict, Dict]:
    """Attacker's target affines: the PUBLIC branch's learned scale/bias,
    with `flipperc` of each layer's scale signs flipped to carry the
    attacker's identity. Returns ({path: {scale, bias}}, {path: b})."""
    with torch.no_grad():
        affines = derive(model, zeros_input(model, input_shape), private)
    pub_scale = {}
    for path in affines:
        block = model.get_submodule(path.replace("/", "."))
        if not isinstance(getattr(block, "scale", None), torch.nn.Parameter):
            # V1 (scheme 1) has no learned public affine: every passport
            # layer derives scale/bias from the passports, so the deployed
            # model SHIPS its passports and the data-free forger has no
            # public-branch target to regress onto. Forging against leaked
            # passports is exactly attack 3 (passport_attack_3.py), which
            # covers V1. See ROBUSTNESS.md.
            raise ValueError(
                f"forge attack needs a learned public affine at '{path}' — "
                "V2/V3 checkpoints only. For scheme 1 use the ambiguity "
                "attack (passport_attack_3.py) instead.")
        pub_scale[path] = {
            "scale": block.scale.detach().cpu().numpy().reshape(-1),
            "bias": block.bias.detach().cpu().numpy().reshape(-1),
        }
    dev = model_device(model)
    rng = np.random.default_rng(seed)
    targets, bs = {}, {}
    for path, sb in pub_scale.items():
        scale = sb["scale"].copy()
        k = int(scale.size * flipperc)
        idx = rng.choice(scale.size, k, replace=False)
        scale[idx] *= -1.0
        targets[path] = {"scale": torch.from_numpy(scale).to(dev),
                         "bias": torch.from_numpy(sb["bias"].copy()).to(dev)}
        bs[path] = torch.from_numpy(
            (np.sign(scale) + (scale == 0)).astype(np.float32)).to(dev)
    return targets, bs


def random_passports(model, seed: int,
                     init: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Tensors:
    """Fresh U(-1, 1) passports shaped as the model's, as leaves that
    require a gradient. The JAX package draws them from ``jax.random``;
    ``init`` (by name) replaces the port's draws, as the tests inject
    JAX's."""
    own = passports(model)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name in tree_order(own):
        t = (torch.rand(own[name].shape, generator=gen) * 2.0 - 1.0
             if init is None
             else torch.as_tensor(init[name], dtype=torch.float32))
        out[name] = t.to(own[name].device).clone().requires_grad_(True)
    return out


def forge_loss(model, pp: Mapping[str, torch.Tensor], targets: Dict,
               x0: torch.Tensor, private: bool):
    """(regression loss, sign accuracy against the targets) of the derived
    affines under the passports ``pp``; differentiable in ``pp``."""
    affs = derive(model, x0, private, pp)
    loss = torch.zeros((), device=x0.device)
    sign_ok = total = 0.0
    for path, aux in affs.items():
        t = targets[path]
        s = aux["scale"].reshape(-1)
        loss = loss + torch.mean((s - t["scale"]) ** 2)
        loss = loss + torch.mean((aux["bias"].reshape(-1) - t["bias"]) ** 2)
        sign_ok = sign_ok + torch.sum(torch.sign(s) == torch.sign(t["scale"]))
        total += s.numel()
    # times the f32 reciprocal, as XLA evaluates the JAX package's division
    return loss, sign_ok * (1.0 / total)


def forge_attack(
    model,
    input_shape,
    flipperc: float = 0.0,
    steps: int = 300,
    lr: float = 0.05,
    seed: int = 0,
    private: bool = True,
    log_every: int = 50,
    init: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Tensors, Dict, List[Dict]]:
    """Optimize fresh random passports (Adam) so derived affines hit the
    forged targets. Returns (forged_passports, attacker_signature,
    history). ``init``: injected U(-1, 1) draws (``random_passports``)."""
    targets, attacker_b = forge_targets(model, input_shape, flipperc, seed,
                                        private)
    # fresh random passports — the attacker has no originals to start from
    pp = random_passports(model, seed + 1, init)
    x0 = zeros_input(model, input_shape)
    opt = torch.optim.Adam(list(pp.values()), lr=lr)

    history: List[Dict] = []
    for t in range(1, steps + 1):
        loss, sacc = forge_loss(model, pp, targets, x0, private)
        _set_grads(pp, loss)
        opt.step()
        if t % log_every == 0 or t == steps:
            history.append({"step": t, "flipperc": flipperc,
                            "mse": float(loss.detach()),
                            "sign_acc": float(sacc)})
    return {k: v.detach() for k, v in pp.items()}, attacker_b, history


def _set_grads(pp: Tensors, loss: torch.Tensor) -> None:
    """The passports' gradients of ``loss`` into their ``.grad``, for the
    optimizer; the model's own parameters get none."""
    names = list(pp)
    for k, g in zip(names, torch.autograd.grad(loss, [pp[k] for k in names])):
        pp[k].grad = g


def refine_with_data(
    model,
    forged_pp: Mapping[str, torch.Tensor],
    attacker_b: Dict,
    train_data,
    epochs: int = 5,
    lr: float = 0.01,
    private: bool = True,
) -> Tuple[Tensors, List[Dict]]:
    """Data-assisted forgery: fine-tune the regression-forged passports with
    CE on the attacker's (limited) data + sign loss for the attacker's
    signature (clip to global norm 2, then Adam)."""
    dev = model_device(model)
    kwargs = {"ind": 1} if private else {"force_passport": True}
    pp = {k: v.detach().clone().requires_grad_(True)
          for k, v in forged_pp.items()}
    names = tree_order(pp)
    opt = torch.optim.Adam([pp[k] for k in names], lr=lr)

    def loss_fn(x, y):
        with eval_mode(model):
            out = functional_call(model, dict(pp), (x,), kwargs)
        ce = cross_entropy_mean(out.logits, y)
        sl = torch.zeros((), device=dev)
        sign_ok = total = 0.0
        for path, aux in out.aux.items():
            b = attacker_b[path]
            s = aux["scale"].reshape(-1)
            sl = sl + aux["alpha"] * torch.sum(torch.relu(0.1 - b * s))
            sign_ok = sign_ok + torch.sum(torch.sign(s) == b)
            total += s.numel()
        return ce + sl, {"ce": ce, "sign_loss": sl,
                         "sign_acc": sign_ok * (1.0 / total)}

    history: List[Dict] = []
    for ep in range(1, epochs + 1):
        sums, nb = None, 0
        for batch in train_data:
            x = nhwc_to_nchw(batch["image"], dev)
            y = torch.as_tensor(batch["label"], device=dev).long()
            loss, m = loss_fn(x, y)
            _set_grads(pp, loss)
            with torch.no_grad():
                clipped = clip_by_global_norm([pp[k].grad for k in names])
                for k, g in zip(names, clipped):
                    pp[k].grad = g
            opt.step()
            m = {k: v.detach() for k, v in m.items()}
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
            nb += 1
        history.append({"epoch": ep,
                        **{k: float(v) / nb for k, v in sums.items()}})
    return {k: v.detach() for k, v in pp.items()}, history


def forged_signature_accuracy(
    model, forged_pp: Mapping[str, torch.Tensor], attacker_b: Dict,
    input_shape, private: bool = True,
) -> float:
    """Mean sign agreement of the forged passports' derived scales with the
    ATTACKER's signature — the counterfeit evidence's quality."""
    with torch.no_grad():
        affs = derive(model, zeros_input(model, input_shape), private,
                      forged_pp)
    ok = tot = 0.0
    for path, aux in affs.items():
        s = torch.sign(aux["scale"].reshape(-1))
        ok += float((s == attacker_b[path].reshape(-1)).sum())
        tot += s.numel()
    return ok / tot
