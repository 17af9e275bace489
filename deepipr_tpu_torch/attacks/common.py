"""Shared attack machinery: affines derived from the passports.

Counterpart of ``deepipr_tpu/attacks/common.py::derived_affines`` (:28-41);
the rest of that module is the attack slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch.func import functional_call

from deepipr_tpu_torch.utils.device import model_device


@torch.inference_mode()
def derived_affines(model, input_shape, private: bool,
                    passports: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, Dict]:
    """{module_path: {'scale','bias','b','alpha'}} derived from the passports.

    One forward of a zeros batch of the NHWC ``input_shape`` with the
    passport branch forced (the reference calls get_scale()/get_bias() per
    layer, experiments/utils.py:201-202). ``passports`` maps passport buffer
    names (``layer4_0.convbnrelu_1.key``) to tensors that stand in for the
    model's own for this call only; the model is not modified.
    """
    kwargs = {"ind": 1} if private else {"force_passport": True}
    n, h, w, c = input_shape
    x = torch.zeros((n, c, h, w), dtype=torch.float32,
                    device=model_device(model))
    if passports is None:
        out = model(x, **kwargs)
    else:
        out = functional_call(model, dict(passports), (x,), kwargs)
    return dict(out.aux)
