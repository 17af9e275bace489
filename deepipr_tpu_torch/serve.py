"""Deployment & verification API: the paper's ownership workflow as a library.

Counterpart of ``deepipr_tpu/serve.py``.

- Predictor: batched inference. For V2/V3 models the public branch (ind=0)
  is the deployment path, with no passports needed; the private branch
  (ind=1) is the owner's verification path.
- verify_ownership: white-box verification. Derive scales from the claimed
  passports and compare their signs with the signature, per layer and as
  decoded ASCII (TesterPrivate.test_signature, trainer_private.py:37-71).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from deepipr_tpu_torch.attacks.common import derived_affines
from deepipr_tpu_torch.passport.codec import bit_accuracy, decode_string
from deepipr_tpu_torch.utils.device import (
    DeviceLike,
    nhwc_to_nchw,
    require_on_device,
    resolve_device,
)
from deepipr_tpu_torch.utils.mode import eval_mode


class Predictor:
    """Batched inference on a built model (which holds its weights).

    ``folded=True`` folds BN and the affines of branch ``ind`` into the
    conv weights once, here (interop/fold.py; ``input_shape`` as there),
    and serves the folded model's one branch: no BN and no K2 at run time.
    In f32 that is the faster model. In bf16 it is slower at large batches
    (on the H100, batch 1024: 17-24 % fewer img/s on ResNet18Private, 8-27 %
    on AlexNet; PERF.md section 5): each conv adds its bias in f32, as norm
    type 'none' does in the JAX package, and the add, the ReLU and the cast
    back to bf16 run as separate passes.
    """

    def __init__(self, model, ind: int = 0, force_passport: bool = False,
                 folded: bool = False, input_shape=None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        require_on_device(model, self.device)
        if folded:
            from deepipr_tpu_torch.interop.fold import fold_for_inference

            model = fold_for_inference(model, input_shape, ind=ind)
            ind, force_passport = 0, False  # the folded model has one branch
        self.model = model
        self.ind = ind
        self.force_passport = force_passport

    @torch.inference_mode()
    def logits(self, x) -> torch.Tensor:
        """x: NHWC f32 batch (numpy or tensor) -> (N, classes) logits, in
        eval mode whatever the model's mode."""
        with eval_mode(self.model):
            return self.model(nhwc_to_nchw(x, self.device), ind=self.ind,
                              force_passport=self.force_passport).logits

    def predict(self, x) -> torch.Tensor:
        return self.logits(x).argmax(dim=-1)


def passports(model) -> Dict[str, torch.Tensor]:
    """The model's passport buffers by name (``layer4_0.convbnrelu_1.key``):
    the layout ``verify_ownership`` takes a claim in."""
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("key", "skey")}


def _claim(model, claimed: Mapping[str, object], device) -> Dict[str, torch.Tensor]:
    own = passports(model)
    if set(claimed) != set(own):
        raise ValueError(
            "claimed passports must name exactly the model's passports; "
            f"missing {sorted(set(own) - set(claimed))}, "
            f"unknown {sorted(set(claimed) - set(own))}")
    out = {}
    for name, value in claimed.items():
        t = torch.as_tensor(value, dtype=torch.float32, device=device)
        if t.shape != own[name].shape:
            raise ValueError(f"claimed passport {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(own[name].shape)}")
        out[name] = t.contiguous()
    return out


def verify_ownership(
    model,
    input_shape,
    private: bool,
    claimed_passports: Optional[Mapping[str, object]] = None,
    num_chars: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """White-box ownership check.

    With claimed_passports=None the model's own passports are used (owner
    verification); an attacker's claim is checked by passing theirs, keyed
    as ``passports(model)`` is, in NCHW. The model is not modified.
    ``input_shape`` is NHWC. Returns per-layer detection rates, their mean,
    and with ``num_chars`` the decoded ASCII text per layer.
    """
    dev = resolve_device(device)
    require_on_device(model, dev)
    claim = None
    if claimed_passports is not None:
        claim = _claim(model, claimed_passports, dev)
    affines = derived_affines(model, input_shape, private, passports=claim)

    result: Dict = {"layers": {}, "decoded": {}}
    total = 0.0
    for path, aux in affines.items():
        det = float(bit_accuracy(aux["scale"], aux["b"]))
        result["layers"][path] = det
        total += det
        if num_chars:
            result["decoded"][path] = decode_string(aux["scale"], num_chars)
    result["detection_rate"] = total / max(len(affines), 1)
    result["verified"] = result["detection_rate"] == 1.0
    return result
