"""Pruning attack: global magnitude pruning sweep
(reference pruning_attack.py).

Counterpart of ``deepipr_tpu/attacks/pruning.py``. For p in
{0,10,...,100}%: zero all parameters whose |value| falls below the global
p-th percentile (across EVERY parameter tensor, including biases and norm
affines, but not the passport or signature buffers — pruning_attack.py:54-66),
then report per-layer signature detection (sign of the passport-DERIVED
scale vs b) and validation accuracy. The attacked model is not modified: the
sweep runs on a copy.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from deepipr_tpu_torch.attacks.common import (
    derived_affines,
    detect_signature_from_affines,
)
from deepipr_tpu_torch.train.steps import make_eval_step, run_eval
from deepipr_tpu_torch.utils.device import model_device


def percentile(values: torch.Tensor, perc: float) -> torch.Tensor:
    """``jnp.percentile(values, perc)`` (linear interpolation) of a 1-D f32
    tensor, in its arithmetic: q = f32(perc) / 100 * (n - 1) in f32, then
    low * (1 - w) + high * w of the order statistics. By selection, since
    ``torch.quantile`` refuses more than 2**24 elements (and a full sort
    costs several times as much)."""
    n = values.numel()
    q = np.float32(perc) / np.float32(100.0) * np.float32(n - 1)
    low, high = (min(max(int(f(q)), 0), n - 1) for f in (np.floor, np.ceil))
    w = np.float32(q - np.float32(np.floor(q)))
    lo_v = torch.kthvalue(values, low + 1).values
    hi_v = lo_v if high == low else torch.kthvalue(values, high + 1).values
    return lo_v * float(np.float32(1.0) - w) + hi_v * float(w)


@torch.no_grad()
def global_prune(params: Dict[str, torch.Tensor], perc: float
                 ) -> Dict[str, torch.Tensor]:
    """Zero the smallest-|value| perc% of ALL parameters (global threshold),
    strictly: an entry equal to the threshold is zeroed."""
    if perc == 0:
        return params
    flat = torch.cat([p.detach().abs().reshape(-1) for p in params.values()])
    threshold = percentile(flat, perc)
    return {k: p * (p.abs() > threshold).to(p.dtype) for k, p in params.items()}


def pruning_attack(
    model,
    valid_data,
    input_shape,
    private: bool,
    percents=(0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100),
    wm_data=None,
) -> List[Dict]:
    """Sweep pruning levels; one history row per level.

    ``model`` holds the attacked weights, statistics, passports and
    signatures, on the device the attack runs on. wm_data (V3): trigger-set
    loader — each row also records black-box WM accuracy (wm_acc =
    public/deployed forward; wm_acc_private for private models), the
    reference's trigger-set verification surface
    (experiments/trainer.py:115-126) under this attack."""
    dev = model_device(model)
    work = copy.deepcopy(model)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    own = dict(work.named_parameters())
    # Reference evaluates the DEFAULT forward (pruning_attack.py:80: model(d)):
    # V1 always derives from passports; private models use the public branch.
    eval_step = make_eval_step(work, ind=0, force_passport=False, device=dev)
    wm_priv_step = (make_eval_step(work, ind=1, device=dev)
                    if wm_data is not None and private else None)

    history = []
    for perc in percents:
        with torch.no_grad():
            for k, v in global_prune(params, float(perc)).items():
                own[k].copy_(v)
        affines = derived_affines(work, input_shape, private)
        detection = detect_signature_from_affines(affines)
        row: Dict = {f"detect_{k}": v for k, v in detection.items()}
        row["detect_mean"] = (float(np.mean(list(detection.values())))
                              if affines else 1.0)
        row.update(run_eval(eval_step, valid_data))
        if wm_data is not None:
            row["wm_acc"] = run_eval(eval_step, wm_data)["acc"]
            if wm_priv_step is not None:
                row["wm_acc_private"] = run_eval(wm_priv_step, wm_data)["acc"]
        row["perc"] = perc
        history.append(row)
    return history
