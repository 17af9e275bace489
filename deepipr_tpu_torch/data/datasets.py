"""ImageNet normalization and the synthetic dataset, in NHWC uint8/f32.

Counterpart of the parts of ``deepipr_tpu/data/datasets.py`` that serving
needs (:27-28, :80, :373), kept as a copy: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def synthetic_dataset(
    num_train=2048, num_test=512, size=32, num_classes=10, seed=0,
    noise: float = 0.6,
):
    """Deterministic, CNN-learnable toy data with balanced classes.

    Each class is a low-resolution random template upsampled to the image
    size; examples are template + heavy pixel noise. Same draws as the JAX
    package's ``synthetic_dataset`` for the same seed.
    """
    rng = np.random.default_rng(seed)
    n = num_train + num_test
    y = rng.integers(0, num_classes, n).astype(np.int32)
    low = size // 4
    templates = rng.uniform(-1, 1, (num_classes, low, low, 3)).astype(np.float32)
    up = np.kron(templates, np.ones((1, 4, 4, 1), np.float32))
    signal = up[y]
    eps = rng.normal(0, 1, (n, size, size, 3)).astype(np.float32)
    x = np.clip(128 + 64 * signal + 64 * noise * eps, 0, 255).astype(np.uint8)
    return x[:num_train], y[:num_train], x[num_train:], y[num_train:]


def normalize(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> f32 NHWC, scaled to [0, 1] then ImageNet mean/std."""
    x = batch_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
