"""Sign loss: hinge penalty forcing sign(scale) == b, as a pure function.

Counterpart of ``deepipr_tpu/passport/sign_loss.py``. Reference semantics
(models/losses/sign_loss.py:27,53):

    loss = sum(alpha * relu(0.1 - b * scale)) + 1e-5 * sum(scale ** 2)

The derived scales leave the model as its aux outputs
(``ResNetOutput.aux``) and the train step computes the loss from them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch

# the reference's hard-coded hinge margin and L2 coefficient
HINGE_MARGIN = 0.1
SCALE_REG = 1e-5


def sign_loss(scale: torch.Tensor, b: torch.Tensor,
              alpha: float = 1.0) -> torch.Tensor:
    """Hinge sign loss + small L2 regularizer on the scale vector."""
    scale = scale.reshape(-1)
    b = b.reshape(-1)
    hinge = torch.sum(alpha * torch.relu(HINGE_MARGIN - b * scale))
    reg = SCALE_REG * torch.sum(scale * scale)
    return hinge + reg


def sign_accuracy(scale: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean(sign(b) == sign(scale)), the reference's SignLoss.get_acc."""
    return (torch.sign(b.reshape(-1)) == torch.sign(scale.reshape(-1))
            ).to(torch.float32).mean()


def total_sign_loss(aux_entries: Iterable[Dict[str, Any]], device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the sign losses, mean bit accuracy) over passport-layer aux
    dicts {'scale': (C,), 'b': (C,), 'alpha': float}; (0, 1) on ``device``
    for none (experiments/trainer.py:131-171)."""
    entries = list(aux_entries)
    if not entries:
        return (torch.tensor(0.0, device=device),
                torch.tensor(1.0, device=device))
    losses = [sign_loss(e["scale"], e["b"], e["alpha"]) for e in entries]
    accs = [sign_accuracy(e["scale"], e["b"]) for e in entries]
    # times the f32 reciprocal, as XLA evaluates the JAX package's
    # sum/len: the mean accuracy then agrees bit for bit
    return sum(losses), sum(accs) * (1.0 / len(accs))
