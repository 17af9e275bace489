"""Everything a run hands the program and the reference, made from ``--seed``.

Weights, BN statistics, passports and signatures, the training set, the
epochs' permutations and the input stage's draws, and the request pool.
Each is made on the run's device by a generator seeded from (seed, purpose),
in a few large calls; the same seed gives the same values, so the reference
regenerates what it needs after the window instead of keeping a copy.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed that depends on ``seed`` and ``tags`` alone."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device: torch.device, seed: int, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


def _draw_of(name: str, shape: Tuple[int, ...]):
    """(kind, a, b) of a leaf: a normal of mean a and deviation b, a uniform
    on [a, b), or signs. Convolutions: He normal over fan-out; the head:
    normal of variance 1/fan-in; BN and the passport blocks' learned affines
    near identity; running statistics of a trained model's order; passports
    uniform on [-1, 1); signatures random signs."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("conv.weight"):
        return "normal", 0.0, (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
    if name == "linear.weight":
        return "normal", 0.0, shape[1] ** -0.5
    if leaf in ("weight", "scale"):
        return "normal", 1.0, 0.1
    if leaf in ("bias", "running_mean"):
        return "normal", 0.0, 0.1
    if leaf == "running_var":
        return "uniform", 0.5, 2.0
    if leaf in ("key", "skey"):
        return "uniform", -1.0, 1.0
    if leaf == "b":
        return "sign", -1.0, 1.0
    raise ValueError(f"no draw for leaf {name}")


def make_values(shapes: Dict[str, Tuple[int, ...]], seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """A float32 value of every named leaf: one normal and one uniform draw
    for all of them, shifted and scaled leaf by leaf."""
    gen = generator(device, seed, "weights")
    groups = {"normal": [], "uniform": []}
    for name, shape in shapes.items():
        kind, a, b = _draw_of(name, tuple(shape))
        groups["uniform" if kind == "sign" else kind].append(
            (name, tuple(shape), kind, a, b))
    values = {}
    for kind, leaves in groups.items():
        if not leaves:
            continue
        sizes = [int(np.prod(s)) for _, s, *_ in leaves]
        total = sum(sizes)
        reps = torch.tensor(sizes, device=device)
        a = torch.repeat_interleave(
            torch.tensor([l[3] for l in leaves], device=device), reps,
            output_size=total)
        b = torch.repeat_interleave(
            torch.tensor([l[4] for l in leaves], device=device), reps,
            output_size=total)
        if kind == "normal":
            flat = torch.randn(total, generator=gen, device=device) * b + a
        else:
            flat = a + (b - a) * torch.rand(total, generator=gen,
                                            device=device)
        for (name, shape, leaf_kind, *_), piece in zip(
                leaves, flat.split(sizes)):
            if leaf_kind == "sign":
                piece = torch.where(piece >= 0, 1.0, -1.0)
            values[name] = piece.view(shape)
    return values


def train_set(seed: int, n: int, hw: int, channels: int, classes: int,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, C) uint8 images and (N,) int64 labels."""
    gen = generator(device, seed, "train_set")
    images = torch.randint(0, 256, (n, hw, hw, channels), dtype=torch.uint8,
                           generator=gen, device=device)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    return images, labels


def permutation(seed: int, n: int, device: torch.device, *tags
                ) -> torch.Tensor:
    return torch.randperm(n, generator=generator(device, seed, "perm", *tags),
                          device=device)


def draw_table(seed: int, steps: int, batch: int, pad: int,
               device: torch.device, *tags) -> Tuple[torch.Tensor, ...]:
    """(oy, ox, flip), each (steps, batch) int32: crop offsets uniform in
    [0, 2 * pad], flips with probability 1/2."""
    gen = generator(device, seed, "draws", *tags)
    kw = dict(generator=gen, device=device, dtype=torch.int32)
    return (torch.randint(0, 2 * pad + 1, (steps, batch), **kw),
            torch.randint(0, 2 * pad + 1, (steps, batch), **kw),
            torch.randint(0, 2, (steps, batch), **kw))


def request_pool(seed: int, count: int, batch: int, hw: int, channels: int,
                 device: torch.device) -> List[np.ndarray]:
    """``count`` NHWC float32 batches of normalized images, made on the
    device and held on the host, where a caller's batches are."""
    gen = generator(device, seed, "requests")
    pool = torch.randn((count, batch, hw, hw, channels), generator=gen,
                       device=device).cpu().numpy()
    return list(pool)
