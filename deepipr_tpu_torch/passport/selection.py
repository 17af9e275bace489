"""Passport selection: build one passport from N candidate activation maps.

Counterpart of ``deepipr_tpu/passport/selection.py`` (kept as a copy: the
port imports nothing of the JAX package), in the port's NCHW layout.
Reference semantics (models/layers/passportconv2d.py:90-123): given
candidates of shape (B, C, H, W),

- if C == 3 (raw input images): return one randomly chosen image;
- else: assemble a single (1, C, H, W) passport whose channel j is a
  randomly chosen, not-yet-used channel of candidate image (j mod B): picks
  cycle through the images round-robin, sampling channels without
  replacement within each image.

It runs once, host-side, on NumPy with an explicit seed; the draws are the
JAX package's, so equal candidates and seeds give equal passports.
"""

from __future__ import annotations

import numpy as np


def passport_selection(candidates: np.ndarray, seed: int) -> np.ndarray:
    """Channel-shuffle selection of a single passport from NCHW candidates."""
    candidates = np.asarray(candidates)
    b, c, h, w = candidates.shape
    rng = np.random.default_rng(seed)

    if c == 3:  # raw input images: pick one whole image
        idx = int(rng.integers(0, b))
        return candidates[idx: idx + 1]

    # per-image channel picks, round-robin over images
    picks_per_image = [len(range(i, c, b)) for i in range(b)]
    chosen = [rng.choice(c, size=k, replace=False) for k in picks_per_image]
    out = np.empty((1, c, h, w), dtype=candidates.dtype)
    for j in range(c):
        img = j % b
        out[0, j] = candidates[img, chosen[img][j // b]]
    return out


def random_passport(shape, seed: int, dtype=np.float32) -> np.ndarray:
    """U(-1, 1) random passport of ``shape`` with the batch forced to 1
    (the reference's generate_key, passportconv2d.py:198-207)."""
    newshape = (1,) + tuple(shape[1:])
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, newshape).astype(dtype)
