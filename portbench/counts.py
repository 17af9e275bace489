"""Operations and bytes of the benchmark's work, from the reference's shapes.

FLOPs count convolutions and dense layers only, two a multiply-add, with
no recomputation. A V2 train step runs the shared prefix once and the
passport suffix once per branch (the split step), and its backward is
counted as twice its forward. A private forward convolves each passport
block's key and skey as two more rows.

Bytes are the least a kernel must move: each input byte read once, each
output byte written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.reference.resnet import conv_out, layer_specs

PASSPORT_ROWS = 2  # key and skey, convolved beside a passport block's input


def _conv_flops(sub) -> int:
    _, k, s, p, _, cin, cout, hw, _ = sub
    oh, ow = conv_out(hw, k, s, p)
    return 2 * cin * cout * k * k * oh * ow


def forward_flops(config: Dict) -> Dict[str, int]:
    """FLOPs of one input row: 'prefix' (the units before the first that
    holds a passport block), 'suffix' (that unit and the rest), 'head'; and
    'passport', the FLOPs of one row through every passport block."""
    out = {"prefix": 0, "suffix": 0, "passport": 0}
    forked = False
    for _, subs in layer_specs(config):
        forked = forked or any(sub[-1] for sub in subs)
        for sub in subs:
            f = _conv_flops(sub)
            out["suffix" if forked else "prefix"] += f
            if sub[-1]:
                out["passport"] += f
    width = 512 * (4 if config["block"] == "bottleneck" else 1)
    out["head"] = 2 * width * config["num_classes"]
    return out


def train_step_flops(config: Dict, batch: int) -> int:
    f = forward_flops(config)
    forward = (batch * (f["prefix"] + 2 * f["suffix"] + 2 * f["head"])
               + PASSPORT_ROWS * f["passport"])
    return 3 * forward


def infer_request_flops(config: Dict, batch: int, ind: int) -> int:
    f = forward_flops(config)
    return (batch * (f["prefix"] + f["suffix"] + f["head"])
            + (PASSPORT_ROWS * f["passport"] if ind == 1 else 0))


def k1_bytes(batch: int, hw: int, channels: int, itemsize: int) -> int:
    """Kernel K1: the batch's uint8 rows read, the normalized NCHW batch
    written, the row indices and three draws (int32 each) and the two
    per-channel statistics read."""
    pixels = batch * hw * hw * channels
    return pixels + pixels * itemsize + 4 * 4 * batch + 2 * 4 * channels


def k2_bytes(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Kernel K2 at y (n, c, h, w): y read and out written in the compute
    dtype; the two float32 passport planes and the running mean and
    variance read; the float32 scale and bias written."""
    return 2 * n * c * h * w * itemsize + 2 * c * h * w * 4 + 4 * c * 4


def k2_shapes(config: Dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """y's shape at each passport block of a private forward."""
    shapes = []
    for _, subs in layer_specs(config):
        for sub in subs:
            if sub[-1]:
                _, k, s, p, _, _, cout, hw, _ = sub
                shapes.append((batch, cout) + conv_out(hw, k, s, p))
    return shapes
