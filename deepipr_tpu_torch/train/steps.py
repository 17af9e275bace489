"""Eval steps, both-branch eval and signature detection.

Counterpart of the eval half of ``deepipr_tpu/train/steps.py`` (:54-78,
:255-386). The model holds its own weights, so a step is called with a batch
alone; ``batch["image"]`` is NHWC as in the JAX package, ``batch["label"]``
integer class ids. Steps return per-batch sums as device tensors, and the
``run_*`` loops read them back once at the end.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.models.branching import branch_point
from deepipr_tpu_torch.passport.codec import bit_accuracy
from deepipr_tpu_torch.utils.device import (
    DeviceLike,
    nhwc_to_nchw,
    require_on_device,
    resolve_device,
)


def collect_aux_with_paths(aux: Dict[str, Dict[str, Any]]
                           ) -> List[Tuple[str, Dict[str, Any]]]:
    """The model's derived-affine outputs as (module path, aux) pairs."""
    return list(aux.items())


def _batch(batch, device):
    x = nhwc_to_nchw(batch["image"], device)
    y = torch.as_tensor(batch["label"], device=device).long()
    return x, y


def _sums(logits, y):
    ce = F.cross_entropy(logits, y, reduction="sum")
    correct = (logits.argmax(dim=-1) == y).sum()
    return ce, correct


def make_dual_eval_step(model, split_branches: bool = True,
                        device: DeviceLike = "cuda"):
    """Both-branch eval in one data pass (reference TesterPrivate.test,
    trainer_private.py:218-251).

    The shared prefix up to the first passport block runs once and the
    private branch forks from its output: at eval the branches are identical
    up to that block (same weights, same BN running stats)."""
    dev = resolve_device(device)
    require_on_device(model, dev)
    fork = branch_point(model) if split_branches else None

    @torch.inference_mode()
    def step(batch):
        x, y = _batch(batch, dev)
        if fork is not None:
            name, _ = fork
            out0 = model(x, ind=0, tap_at=name)
            logits0 = out0.logits
            logits1 = model(out0.tap, ind=1, start_at=name).logits
        else:
            logits0 = model(x, ind=0).logits
            logits1 = model(x, ind=1).logits
        out = {}
        for tag, logits in (("public", logits0), ("private", logits1)):
            out[f"ce_sum_{tag}"], out[f"correct_{tag}"] = _sums(logits, y)
        return out

    return step


def run_dual_eval(step, dataset) -> Dict[str, float]:
    """Drive a dual eval step -> the TesterPrivate metric dict."""
    sums, count = None, 0
    for batch in dataset:
        out = step(batch)
        sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        count += len(batch["label"])
    if count == 0:
        return {"loss_public": 0.0, "acc_public": 0.0,
                "loss_private": 0.0, "acc_private": 0.0, "total_acc": 0.0}
    res = {
        "loss_public": float(sums["ce_sum_public"]) / count,
        "acc_public": 100.0 * int(sums["correct_public"]) / count,
        "loss_private": float(sums["ce_sum_private"]) / count,
        "acc_private": 100.0 * int(sums["correct_private"]) / count,
    }
    res["total_acc"] = (res["acc_public"] + res["acc_private"]) / 2
    return res


def make_eval_step(model, ind: int = 0, force_passport: bool = False,
                   device: DeviceLike = "cuda"):
    """Sum-reduced CE + correct-count eval step (reference Tester.test)."""
    dev = resolve_device(device)
    require_on_device(model, dev)

    @torch.inference_mode()
    def step(batch):
        x, y = _batch(batch, dev)
        logits = model(x, ind=ind, force_passport=force_passport).logits
        ce_sum, correct = _sums(logits, y)
        return {"ce_sum": ce_sum, "correct": correct}

    return step


def run_eval(step, dataset) -> Dict[str, float]:
    """Drive a prebuilt eval step over a dataset -> {'loss', 'acc'}."""
    ce_sum, correct, count = None, None, 0
    for batch in dataset:
        out = step(batch)
        ce_sum = out["ce_sum"] if ce_sum is None else ce_sum + out["ce_sum"]
        correct = out["correct"] if correct is None else correct + out["correct"]
        count += len(batch["label"])
    if count == 0:
        return {"loss": 0.0, "acc": 0.0}
    return {"loss": float(ce_sum) / count, "acc": 100.0 * int(correct) / count}


def evaluate(model, dataset, ind: int = 0, force_passport: bool = False,
             device: DeviceLike = "cuda") -> Dict[str, float]:
    """One-shot full-dataset eval."""
    step = make_eval_step(model, ind=ind, force_passport=force_passport,
                          device=device)
    return run_eval(step, dataset)


def make_signature_fn(model, input_shape, private: bool,
                      device: DeviceLike = "cuda"):
    """Signature detection (TesterPrivate.test_signature,
    trainer_private.py:37-71): fn() -> {layer_path: detection_rate}.

    The derived scale depends only on (conv kernel, skey), so a zeros input
    of the NHWC ``input_shape`` drives the model once with the passport
    branch forced.
    """
    dev = resolve_device(device)
    require_on_device(model, dev)
    prefix = "private_" if private else "public_"

    def fn() -> Dict[str, float]:
        affines = derived_affines(model, input_shape, private)
        return {prefix + path: float(bit_accuracy(aux["scale"], aux["b"]))
                for path, aux in affines.items()}

    return fn


def test_signature(model, input_shape, private: bool,
                   device: DeviceLike = "cuda") -> Dict[str, float]:
    """One-shot convenience wrapper around make_signature_fn."""
    return make_signature_fn(model, input_shape, private, device=device)()
