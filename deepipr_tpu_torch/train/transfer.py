"""Transfer learning: fine-tune a clone and test signature survival.

Counterpart of ``deepipr_tpu/train/transfer.py`` (reference
experiments/classification.py:142-263, classification_private.py:161-330):

1. Clone the trained model into a NORMAL model sized for the TL dataset
   (passport layers' derived scale/bias -> norm affine).
2. rtal: a fresh last classifier; ftal: keep it (a fresh one all the same
   when the class count differs).
3. Fine-tune the clone with SGD (momentum 0.9, decay 5e-4) under the
   experiment's MultiStepLR, on the host path without the random crop.
4. Each epoch, read whether the signature survives in the original passport
   model with the fine-tuned weights copied back:
   - V1: the sign of the fine-tuned norm affine scale against b (the
     reference materializes the affine into learnable scale parameters and
     reads them);
   - V2/V3: the private scale derived from the fine-tuned conv kernels;
   - V3: the trigger set through the copied-back model, both branches
     ('Old WM Accuracy').

The JAX package's state is immutable, so its copies back are new states.
The port's model holds its weights: the experiment's model is never
written. The derivation reads the fine-tuned kernels through
``functional_call``, and the trigger set runs on a copy of the model that
takes the fine-tuned weights each epoch; ``exp.model`` is the trained model
bit for bit afterwards.
"""

from __future__ import annotations

import copy
import csv
import os
from typing import Dict, List, Mapping, Optional

import torch

from deepipr_tpu_torch.attacks.common import (
    derive,
    derived_affines,
    jax_path,
    plkey_to_module_path,
    zeros_input,
)
from deepipr_tpu_torch.data.datasets import prepare_dataset
from deepipr_tpu_torch.interop.surgery import (
    _last_classifier_module,
    copy_matching,
    normal_to_normal,
    passport_to_normal,
)
from deepipr_tpu_torch.models.registry import NUM_CLASSES, build_model
from deepipr_tpu_torch.passport.codec import bit_accuracy
from deepipr_tpu_torch.train.schedule import multistep_lr
from deepipr_tpu_torch.train.state import TrainState
from deepipr_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    run_eval,
)
from deepipr_tpu_torch.utils.checkpoint import save_state


@torch.no_grad()
def _copy_back(exp, tl_model, into) -> None:
    """``into`` (a copy of ``exp.model``) with the fine-tuned clone's
    matching weights and BN statistics: the reference's per-epoch
    ``self.model.load_state_dict(tl_model.state_dict())`` surgery
    (classification_private.py:275-305; JAX ``_copied_back_state``)."""
    into.load_state_dict(copy_matching(tl_model.state_dict(),
                                       exp.model.state_dict()))


def _signature_survival(exp, tl_model, plpaths: List[str]) -> Dict[str, float]:
    """Per-layer signature detection after fine-tuning, keyed by JAX module
    path as the JAX package's columns are."""
    out = {}
    if exp.private:
        # the fine-tuned parameters stand in for the passport model's own
        own = dict(exp.model.named_parameters())
        tuned = {k: v for k, v in tl_model.named_parameters()
                 if k in own and own[k].shape == v.shape}
        shape = (1, exp.imgcrop, exp.imgcrop, exp.in_channels)
        with torch.inference_mode():
            affines = derive(exp.model, zeros_input(exp.model, shape), True,
                             tuned)
        for path, aux in affines.items():
            out[f"private_{path}"] = float(bit_accuracy(aux["scale"],
                                                        aux["b"]))
    else:
        # V1: the fine-tuned norm affine is the materialized scale
        tuned = tl_model.state_dict()
        for path in plpaths:
            b = exp.model.get_submodule(path).b
            out[f"public_{jax_path(path)}"] = float(
                bit_accuracy(tuned[f"{path}.bn.weight"], b))
    return out


def transfer_learning(exp, init: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> List[Dict]:
    """Run the TL loop on a constructed ClassificationExperiment (built with
    ``transfer_learning`` set, its model loaded from the attacked
    checkpoint); returns the per-epoch rows, also written to
    ``{logdir}/tl_1/history.csv`` beside ``tl_1/models/tl-best.ckpt`` and
    ``tl-last.ckpt``. ``init``: the clone's initial state dict in place of
    its seeded initialization, the source of rtal's fresh classifier (tests
    hand over the JAX package's, W7). Under ``--multihost`` every rank
    fine-tunes on the whole batch, as the JAX package's unsharded loop
    does, and rank 0 alone writes."""
    tl_classes = NUM_CLASSES[exp.tl_dataset]
    tl_model = build_model(exp.arch, tl_classes, exp.norm_type,
                           imagenet=exp.num_classes == 1000,
                           input_size=exp.imgcrop, seed=exp.seed + 100,
                           device=exp.device)
    fresh = dict(tl_model.state_dict() if init is None else init)

    plpaths = [plkey_to_module_path(k) for k in exp.plkeys]
    skip_last = exp.tl_scheme == "rtal" or tl_classes != exp.num_classes
    trained = exp.model.state_dict()
    if exp.scheme == 0:
        state = normal_to_normal(trained, fresh, skip_last_classifier=skip_last)
    else:
        shape = (1, exp.imgcrop, exp.imgcrop, exp.in_channels)
        affines = derived_affines(exp.model, shape, exp.private)
        state = passport_to_normal(trained, affines, fresh, plpaths)
        if skip_last:
            # rtal: the fresh random last classifier
            last = _last_classifier_module(fresh)
            state.update({k: v for k, v in fresh.items()
                          if k.split(".")[0] == last})
    with torch.no_grad():
        tl_model.load_state_dict(state)  # copies: nothing shared with exp

    tl_args = dict(exp.args, transfer_learning=True)
    train_data, valid_data = prepare_dataset(tl_args)
    schedule = multistep_lr(exp.lr, exp.lr_config, len(train_data))
    tl_state = TrainState.create(tl_model, schedule, momentum=0.9,
                                 weight_decay=5e-4)
    train_step = make_train_step(tl_model, private=False, device=exp.device)
    eval_step = make_eval_step(tl_model, device=exp.device)
    backdoor = exp.train_backdoor and exp.wm_data is not None
    copied_back = copy.deepcopy(exp.model) if backdoor else None

    tl_dir = os.path.join(exp.logdir, "tl_1")
    writer = exp.writer
    if writer:
        os.makedirs(os.path.join(tl_dir, "models"), exist_ok=True)
    history: List[Dict] = []
    best = float("-inf")
    for ep in range(1, exp.epochs + 1):
        sums, nb = {}, 0
        for batch in train_data:
            tl_state, metrics = train_step(tl_state, batch)
            nb += 1
            # summed in f64 on the device, as the JAX loop adds Python floats
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.double()
        row = {f"train_{k}": float(v) / nb for k, v in sums.items()}
        row.update({f"valid_{k}": v
                    for k, v in run_eval(eval_step, valid_data).items()})
        if exp.scheme != 0:
            row.update({f"old_wm_passport_{k}": v for k, v in
                        _signature_survival(exp, tl_model, plpaths).items()})
        if backdoor:
            # does the backdoor survive fine-tuning? The trigger set through
            # the original model with the fine-tuned weights copied back
            _copy_back(exp, tl_model, copied_back)
            row.update({f"backdoor_{k}": v for k, v in
                        exp._dual_eval(exp.wm_data, copied_back).items()})
        row["epoch"] = ep
        history.append(row)
        print(f"TL epoch {ep:3d} " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(row.items()) if k != "epoch"))

        if not writer:
            continue
        if row["valid_acc"] > best:
            best = row["valid_acc"]
            save_state(os.path.join(tl_dir, "models", "tl-best.ckpt"),
                       tl_state)
        save_state(os.path.join(tl_dir, "models", "tl-last.ckpt"), tl_state)

    if not writer:
        return history
    with open(os.path.join(tl_dir, "history.csv"), "w", newline="") as f:
        cols = sorted({k for r in history for k in r})
        w = csv.writer(f)
        w.writerow(cols)
        for r in history:
            w.writerow([r.get(c, "") for c in cols])
    return history
