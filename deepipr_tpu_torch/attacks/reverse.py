"""Attack 2 — reverse-engineer scale/bias (reference passport_attack_2.py).

Counterpart of ``deepipr_tpu/attacks/reverse.py``. The attacker builds a
NORMAL model from a trained passport checkpoint: conv weights copied, each
passport layer's derived scale/bias materialized into the norm affine. All
weights are frozen EXCEPT those norm affines; a fraction of the scale signs
is flipped (values replaced by +-1 signs — the reference's quirk at
passport_attack_2.py:273-281 — and the biases zeroed), then only the
affines are retrained to recover accuracy.

The JAX package freezes the rest with ``optax.multi_transform`` and
``set_to_zero`` (``reverse.py:72-89``); here the optimizer holds only the
2·|plpaths| affines and every other parameter stops requiring a gradient,
which moves the same weights. The normal model trains in train mode, so
every BN running statistic still moves (``reverse.py:106-107``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from deepipr_tpu_torch.attacks.common import derived_affines, global_sign_flip
from deepipr_tpu_torch.interop.surgery import passport_to_normal
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import (
    cross_entropy_mean,
    make_eval_step,
    run_eval,
    top1_accuracy,
)
from deepipr_tpu_torch.utils.device import model_device, nhwc_to_nchw


def build_attacked_normal_state(
    passport_model,
    normal_model,
    input_shape,
    private: bool,
    plpaths: List[str],
    flipperc: float,
    lr: float = 0.01,
    seed: int = 0,
):
    """Load the attacker's weights into ``normal_model`` (in place) and
    return (its TrainState over the passport layers' norm affines alone, the
    flipped scales' sign similarity)."""
    affines = derived_affines(passport_model, input_shape, private)
    state = passport_to_normal(passport_model.state_dict(), affines,
                               normal_model.state_dict(), plpaths)

    # zero biases + flip perc of scale signs (values become +-1)
    scales = [state[f"{p}.bn.weight"].detach().cpu().numpy().copy()
              for p in plpaths]
    flipped, similarity = global_sign_flip(
        scales, flipperc, seed=seed + 1, to_unit_signs=True
    )
    for p, w in zip(plpaths, flipped):
        state[f"{p}.bn.weight"] = torch.from_numpy(w)
        state[f"{p}.bn.bias"] = torch.zeros_like(state[f"{p}.bn.bias"])
    with torch.no_grad():
        normal_model.load_state_dict(state)

    trainable = {f"{p}.bn.{leaf}" for p in plpaths for leaf in ("weight",
                                                                "bias")}
    params = []
    for name, param in normal_model.named_parameters():
        param.requires_grad_(name in trainable)
        param.grad = None
        if name in trainable:
            params.append(param)
    # optax add_decayed_weights(5e-4) -> trace(0.9) -> scale_by_lr(lr) is
    # torch's SGD with weight decay and momentum, no dampening
    optimizer = torch.optim.SGD(params, lr=lr, momentum=0.9,
                                weight_decay=5e-4)
    return TrainState(normal_model, optimizer, lr), similarity


def make_affine_train_step(model):
    """Plain CE train step on the normal model (only the optimizer's
    parameters move; every BN running statistic does too)."""
    dev = model_device(model)

    def step(state: TrainState, batch):
        model.train()
        x = nhwc_to_nchw(batch["image"], dev)
        y = torch.as_tensor(batch["label"], device=dev).long()
        logits = model(x).logits
        ce = cross_entropy_mean(logits, y)
        ce.backward()
        state.apply_gradients()
        return state, {"loss": ce.detach(),
                       "acc": top1_accuracy(logits.detach(), y)}

    return step


def reverse_attack(
    passport_model,
    normal_model,
    train_data,
    valid_data,
    input_shape,
    private: bool,
    plpaths: List[str],
    flipperc: float = 0.0,
    epochs: int = 100,
    lr: float = 0.01,
    seed: int = 0,
    wm_data=None,
) -> List[Dict]:
    """Full attack-2 loop; one history row per epoch (+ epoch-0 baseline).
    ``normal_model`` (built by the caller, on the passport model's device)
    receives the attacker's weights and is trained in place.

    wm_data (V3): per-epoch black-box WM accuracy of the attacked model —
    does the backdoor survive affine-only retraining?"""
    state, similarity = build_attacked_normal_state(
        passport_model, normal_model, input_shape, private, plpaths,
        flipperc, lr, seed,
    )
    dev = model_device(normal_model)
    eval_step = make_eval_step(normal_model, device=dev)
    step = make_affine_train_step(normal_model)

    history: List[Dict] = []
    val = run_eval(eval_step, valid_data)
    row0 = {"epoch": 0, "similarity": similarity,
            **{f"valid_{k}": v for k, v in val.items()}}
    if wm_data is not None:
        row0["wm_acc"] = run_eval(eval_step, wm_data)["acc"]
    history.append(row0)

    for ep in range(1, epochs + 1):
        sums = None
        nb = 0
        for batch in train_data:
            state, metrics = step(state, batch)
            nb += 1
            sums = metrics if sums is None else {
                k: sums[k] + metrics[k] for k in sums}
        row = {f"train_{k}": float(v) / nb for k, v in (sums or {}).items()}
        val = run_eval(eval_step, valid_data)
        row.update({f"valid_{k}": v for k, v in val.items()})
        if wm_data is not None:
            row["wm_acc"] = run_eval(eval_step, wm_data)["acc"]
        row["epoch"] = ep
        history.append(row)
    return history
