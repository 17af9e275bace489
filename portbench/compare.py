"""The numbers that decide ``correct``, and their judgement against limits.

Training (the first steps of the one train state the window goes on with):

- ``loss``: each step's loss (CE of both branches plus the sign loss), the
  largest gap from the reference's, relative to it.
- ``grad``: the first step's gradient as the optimizer takes it, leaf by
  leaf: the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  the worst leaf.
- ``update``: the same for each parameter's change over the steps.
- ``bn``: the same for each BN running statistic's change over the steps.
- ``grad_median``, ``update_median``, ``bn_median``: the median leaf's gap
  in place of the worst's; ``grad_q90``, ``update_q90``, ``bn_q90``: the
  90th percentile of the leaves' gaps (the gap that a tenth of the leaves
  exceed), which a fault in a tenth of the leaves or more moves.

Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out of ``grad`` and ``update``.

Inference (a sample of the window's requests, drawn from the seed):

- ``logits``: the largest gap from the reference's logits, over the root
  mean square of the reference's logits of that request; the worst request.
- ``classes``: the wrong answers: rows whose served class is not the
  reference's best, where that best leads the reference's second by more
  than twice the ``logits`` limit (in the same units), a lead no rounding
  within that limit can overturn. Limit 0.
- ``affine``: the private branch's derived scale and bias of each passport
  block, the largest gap over the reference's root mean square; the worst
  block.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

NOUGHT = 1e-3  # of the median leaf's gradient norm


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves
               ) -> List[float]:
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]


def train_numbers(prog: Dict, ref: Dict, limits: Dict = None
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: {'loss': [per step], 'grad', 'update', 'bn':
    {leaf: norm}}."""
    med = statistics.median(ref["grad"].values())
    counted = [k for k, v in ref["grad"].items() if v >= NOUGHT * med]
    out = {"loss": max(abs(p - r) / abs(r)
                       for p, r in zip(prog["loss"], ref["loss"]))}
    for key, leaves in (("grad", counted), ("update", counted),
                        ("bn", list(ref["bn"]))):
        gaps = _leaf_gaps(prog[key], ref[key], leaves)
        out[key] = max(gaps)
        out[f"{key}_median"] = statistics.median(gaps)
        out[f"{key}_q90"] = statistics.quantiles(gaps, n=10,
                                                 method="inclusive")[-1]
    return out


def _rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


def infer_numbers(prog: List[Dict], ref: List[Dict], limits: Dict
                  ) -> Dict[str, float]:
    """One entry a sampled request, each {'logits': (B, K), 'classes': (B,),
    'affine': {block: (scale, bias)}} (the program's classes are the ones
    served); ``limits``: the cell's, for the lead that makes a row's answer
    unambiguous."""
    logits = affine = 0.0
    wrong = 0
    for p, r in zip(prog, ref):
        z = r["logits"].double()
        scale = _rms(z)
        logits = max(logits, float((p["logits"].double().to(z.device) - z)
                                   .abs().max()) / scale)
        served = torch.as_tensor(p["classes"], device=z.device).long()
        top = z.topk(2, dim=1)
        lead = (top.values[:, 0] - top.values[:, 1]) / scale
        clear = lead > 2 * limits.get("logits", 0.0)
        wrong += int(((served != top.indices[:, 0]) & clear).sum())
        for block, (s_ref, b_ref) in r["affine"].items():
            s_p, b_p = p["affine"][block]
            for got, want in ((s_p, s_ref), (b_p, b_ref)):
                want = want.double()
                affine = max(affine, float((got.double().to(want.device)
                                            - want).abs().max()) / _rms(want))
    out = {"logits": logits, "classes": float(wrong)}
    if ref and ref[0]["affine"]:
        out["affine"] = affine
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {'value', 'limit'}}) over the numbers the cell's
    limits name: each at or under its limit; one not computed, or not
    finite, fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        correct = correct and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
