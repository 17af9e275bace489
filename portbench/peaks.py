"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense, at its 700 W limit: 67
TFLOP/s float32 outside the tensor cores (float32 with TF32 off), 989
TFLOP/s bfloat16, 3.35 TB/s of HBM. A card of another name has no entry,
and the shares of a peak are then left out.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12,
        "bfloat16": 989e12,
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks_for(kind: Optional[str]) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)
