"""Sign-flipping attack (reference flip_attack.py).

Counterpart of ``deepipr_tpu/attacks/flip.py``. For p in {0,...,100}%:
materialize each passport layer's DERIVED scale/bias into explicit affine
parameters, flip the sign of p% of the scale entries (chosen globally across
passport layers), and measure validation accuracy with the flipped affine
plus the signature detection rate — which stays at the passport-derived
value, since detection always reads sign(get_scale(True)) from the untouched
passports (flip_attack.py:19-31).

The flipped scale/bias are injected through the model's public-affine path:
for private models they overwrite the learned public ``scale``/``bias``
parameters; a V1 model must be built with ``learnable_affine=True`` so that
they exist (the reference's init_scale(True); the attack CLI does so). The
attacked model is not modified: the sweep runs on a copy.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping

import numpy as np
import torch

from deepipr_tpu_torch.attacks.common import (
    derived_affines,
    detect_signature_from_affines,
    global_sign_flip,
    jax_path,
)
from deepipr_tpu_torch.train.steps import make_eval_step, run_eval
from deepipr_tpu_torch.utils.device import model_device

State = Dict[str, torch.Tensor]


def materialize_affines(params: Mapping[str, torch.Tensor],
                        affines: Dict[str, Dict], plpaths: List[str]) -> State:
    """Write derived scale/bias into the explicit affine params of each
    passport layer (reference init_scale(True) + copy, flip_attack.py:99-127)."""
    out = dict(params)
    for path in plpaths:
        out[f"{path}.scale"] = affines[jax_path(path)]["scale"].reshape(-1)
        out[f"{path}.bias"] = affines[jax_path(path)]["bias"].reshape(-1)
    return out


def align_stats_with_private(stats: Mapping[str, torch.Tensor],
                             plpaths: List[str]) -> State:
    """For separate-stats checkpoints, copy bn_private running stats over the
    public bn stats at the passport layers.

    The materialized-affine eval runs the PUBLIC forward with the
    PRIVATE-derived scale/bias (reference flip_attack semantics — fine under
    the reference's shared BN). With per-branch stats those affines belong
    with bn_private's statistics; pairing them with the public stats
    evaluates a model nobody trained."""
    out = dict(stats)
    for path in plpaths:
        for stat in ("running_mean", "running_var"):
            priv = f"{path}.bn_private.{stat}"
            if priv in out:
                out[f"{path}.bn.{stat}"] = out[priv]
    return out


def flip_attack(
    model,
    valid_data,
    input_shape,
    private: bool,
    plpaths: List[str],
    percents=(0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100),
    seed: int = 0,
    flip_paths: List[str] = None,
    wm_data=None,
) -> List[Dict]:
    """Sweep flip levels; one history row per level.

    flip_paths (reference --fidxs) restricts flipping to specific layers;
    default: all passport layers. Paths are the port's dotted module names.

    wm_data (V3): trigger-set loader — rows gain black-box WM accuracy of
    the flipped model (reference trainer.py:115-126 verification surface).
    """
    dev = model_device(model)
    affines = derived_affines(model, input_shape, private)
    detection = detect_signature_from_affines(affines)
    work = copy.deepcopy(model)
    state = align_stats_with_private(
        materialize_affines(work.state_dict(), affines, plpaths), plpaths)
    with torch.no_grad():
        work.load_state_dict(state)
    targets = flip_paths or plpaths
    own = dict(work.named_parameters())

    # public/materialized-affine forward (reference model(d) after init_scale)
    eval_step = make_eval_step(work, ind=0, force_passport=False, device=dev)

    history = []
    for perc in percents:
        scales = [affines[jax_path(p)]["scale"].reshape(-1).cpu().numpy().copy()
                  for p in targets]
        flipped, similarity = global_sign_flip(
            scales, perc / 100.0, seed=seed + perc
        )
        with torch.no_grad():
            for path, w in zip(targets, flipped):
                own[f"{path}.scale"].copy_(torch.from_numpy(w))

        row: Dict = {f"detect_{k}": v for k, v in detection.items()}
        row["detect_mean"] = float(np.mean(list(detection.values())))
        row["similarity"] = similarity
        row.update(run_eval(eval_step, valid_data))
        if wm_data is not None:
            row["wm_acc"] = run_eval(eval_step, wm_data)["acc"]
        row["perc"] = perc
        history.append(row)
    return history
