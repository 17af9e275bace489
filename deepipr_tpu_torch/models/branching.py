"""Branch-point discovery for the split dual-forward eval (ResNet).

Counterpart of ``deepipr_tpu/models/branching.py``. The public (ind=0) and
private (ind=1) forwards of a private passport model are identical until the
first passport-flagged block, so the shared prefix runs once and the private
branch forks there. For the flagship resnet18 config, passports live only in
layer4: roughly 3/4 of the network is prefix.

branch_point(model) returns (first passport unit name, [prefix unit names])
or None when splitting buys nothing (no passports / first unit flagged).
AlexNet is a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from deepipr_tpu_torch.models.resnet import ResNet


def _flagged(layer_kwargs) -> bool:
    return bool(layer_kwargs and layer_kwargs.get("flag"))


def branch_point(model) -> Optional[Tuple[str, List[str]]]:
    """(fork unit name, prefix unit names) or None if not splittable."""
    pk = getattr(model, "passport_kwargs", None)
    if pk is None or not isinstance(model, ResNet):
        return None
    units = [("convbnrelu_1", _flagged(pk.get("convbnrelu_1")))]
    for li, n in enumerate(model.num_blocks, start=1):
        layer_pk = pk.get(f"layer{li}") or {}
        for bi in range(n):
            sub = layer_pk.get(str(bi)) or {}
            units.append((
                f"layer{li}_{bi}",
                any(_flagged(v) for v in sub.values()),
            ))

    prefix: List[str] = []
    for name, flagged in units:
        if flagged:
            return (name, prefix) if prefix else None
        prefix.append(name)
    return None  # no passport units at all
