"""Attack 1 — random fake passports (reference passport_attack_1.py).

Counterpart of ``deepipr_tpu/attacks/fake_passport.py``. Repeatedly replace
the model's passports with passports derived from random validation images
(through a pretrained model) and measure how inference accuracy collapses.

The JAX package stacks the R candidate passport sets and vmaps one jitted
evaluation over them (``fake_passport.py:76-97``). ``torch.func.vmap``
cannot batch the epilogue kernel's ctypes launch, so here each rep is one
private forward per batch with its passports swapped in by
``functional_call``: the reference's own form, R sequential evaluations.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from deepipr_tpu_torch.passport.codec import bit_accuracy
from deepipr_tpu_torch.serve import passports
from deepipr_tpu_torch.train.keys import sample_candidates, setup_passports
from deepipr_tpu_torch.utils.device import model_device, nhwc_to_nchw
from deepipr_tpu_torch.utils.mode import eval_mode

Passports = Dict[str, torch.Tensor]


def build_fake_passports(
    pretrained_model,
    model,
    candidates: np.ndarray,
    reps: int,
    seed: int,
    n: int = 20,
) -> List[Passports]:
    """R independent fake passport collections from random candidate images
    (NHWC), keyed as ``serve.passports(model)``, on the model's device; the
    JAX package's seeds (``fake_passport.py:38-46``)."""
    dev = model_device(model)
    out = []
    for r in range(reps):
        kx = sample_candidates(candidates, n, seed=seed + 2 * r)
        ky = sample_candidates(candidates, n, seed=seed + 2 * r + 1)
        fake = setup_passports(pretrained_model, model, kx, ky,
                               seed=seed + 10_000 + r)
        out.append({k: v.to(dev) for k, v in fake.items()})
    return out


def random_passport_attack(
    model,
    pretrained_model,
    candidates: np.ndarray,
    data,
    reps: int,
    private: bool,
    seed: int = 0,
) -> List[Dict]:
    """Evaluate the model under R random fake passports.

    Returns one history row per rep: {'attack_rep', 'valid_acc', 'valid_loss',
    'valid_signacc'} plus a leading row for the genuine passports (rep=-1),
    matching the reference's CSV semantics (passport_attack_1.py:277-289).
    """
    dev = model_device(model)
    fakes = build_fake_passports(pretrained_model, model, candidates, reps,
                                 seed)
    genuine = {k: v.detach() for k, v in passports(model).items()}
    kwargs = {"ind": 1} if private else {"force_passport": True}

    @torch.inference_mode()
    def eval_batch(pp: Mapping[str, torch.Tensor], x, y):
        with eval_mode(model):
            out = functional_call(model, dict(pp), (x,), kwargs)
        ce = F.cross_entropy(out.logits, y, reduction="sum")
        correct = (out.logits.argmax(dim=-1) == y).sum()
        auxes = list(out.aux.values())
        # the mean times the f32 reciprocal, as XLA evaluates sum/len
        sacc = (sum(bit_accuracy(a["scale"], a["b"]) for a in auxes)
                * (1.0 / len(auxes)) if auxes
                else torch.tensor(1.0, device=dev))
        return torch.stack([ce, correct.to(ce.dtype), sacc])

    # (reps + 1, 3), genuine first, summed over batches in f64 as the JAX
    # package sums its per-batch f32 results in NumPy; one host read
    sums = None
    count = nbatches = 0
    for batch in data:
        x = nhwc_to_nchw(batch["image"], dev)
        y = torch.as_tensor(batch["label"], device=dev).long()
        rows = torch.stack([eval_batch(pp, x, y)
                            for pp in [genuine, *fakes]]).double()
        sums = rows if sums is None else sums + rows
        count += len(batch["label"])
        nbatches += 1

    sums = sums.cpu().numpy()
    history = []
    for r in range(-1, reps):
        ce, correct, sacc = sums[r + 1]
        history.append({
            "attack_rep": r,
            "valid_loss": float(ce) / count,
            "valid_acc": 100.0 * float(correct) / count,
            "valid_signacc": float(sacc) / nbatches,
        })
    return history
