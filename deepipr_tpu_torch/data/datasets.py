"""Data pipeline: CIFAR / trigger set / synthetic, NHWC uint8 and f32.

Counterpart of ``deepipr_tpu/data/datasets.py``, kept as a copy: the port
imports nothing of the JAX package. The reference's semantics
(dataset.py): train transforms RandomCrop(pad = 4/32 * size) +
RandomHorizontalFlip + ImageNet normalization (:268-293), the crop dropped
in transfer-learning mode (:282-284); test transforms normalization only;
the trigger set (WatermarkNN folder + labels-cifar.txt, CenterCrop, batch 2,
drop_last) cycled onto training batches (:142-193). Batches are NumPy,
augmented on the host by the NumPy path of the JAX package, draw for draw
(its native C++ path belongs to that package). The port reads CIFAR from
local files only: nothing is downloaded. Caltech and ImageNet are ROADMAP
queue 1, item 6.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_cifar(root: str, name: str
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CIFAR-10/100 from the standard python-pickle layout under ``root``
    (``cifar-10-batches-py`` / ``cifar-100-python``) -> NHWC uint8 train and
    test images with int32 labels."""
    if name == "cifar10":
        d = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"CIFAR-10 not found at {d}; place the extracted "
                "cifar-10-batches-py directory there (no network access).")
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(b[b"data"])
            ys.extend(b[b"labels"])
        with open(os.path.join(d, "test_batch"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        test_x, test_y = b[b"data"], b[b"labels"]
    else:
        d = os.path.join(root, "cifar-100-python")
        if not os.path.isdir(d):
            raise FileNotFoundError(f"CIFAR-100 not found at {d}")
        with open(os.path.join(d, "train"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xs, ys = [b[b"data"]], list(b[b"fine_labels"])
        with open(os.path.join(d, "test"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        test_x, test_y = b[b"data"], b[b"fine_labels"]

    def to_nhwc(flat):
        return np.asarray(flat).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    return (to_nhwc(np.concatenate(xs)).astype(np.uint8),
            np.asarray(ys, np.int32),
            to_nhwc(test_x).astype(np.uint8),
            np.asarray(test_y, np.int32))


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


def _apply_crop_flip(batch_u8, ys, xs, flips, pad):
    """Zero-pad crop at (ys, xs) + horizontal flip where ``flips``."""
    n, h, w, c = batch_u8.shape
    out = batch_u8
    if pad > 0:
        padded = np.pad(out, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="constant")
        out = np.stack([padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
                        for i in range(n)])
    out = out.copy()
    out[flips] = out[flips, :, ::-1]
    return out


def augment_normalize(batch_u8: np.ndarray, rng: np.random.Generator,
                      pad: int, random_crop: bool = True) -> np.ndarray:
    """Train transform: zero-pad random crop + hflip + normalization, with
    the JAX package's draws from ``rng`` (crop rows, crop columns, flips)."""
    n = batch_u8.shape[0]
    crop_pad = pad if (random_crop and pad > 0) else 0
    if crop_pad:
        ys = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
        xs = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
    else:
        ys = np.zeros(n, np.int32)
        xs = np.zeros(n, np.int32)
    flips = rng.random(n) < 0.5
    return normalize(_apply_crop_flip(batch_u8, ys, xs, flips, crop_pad))


class DataLoader:
    """Epoch iterator over in-memory arrays -> {'image', 'label'} batches.

    ``raw=True`` yields the uint8 batches untouched, for the device input
    stage (kernel K1); else ``train_augment`` augments and normalizes on the
    host, and otherwise batches are only normalized.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False,
                 train_augment: bool = False, random_crop: bool = True,
                 drop_last: bool = False, seed: int = 0, raw: bool = False):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.train_augment = train_augment
        self.raw = raw
        self.random_crop = random_crop
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.pad = int((4 / 32) * images.shape[1])

    def __len__(self):
        n = len(self.images) // self.batch_size
        if not self.drop_last and len(self.images) % self.batch_size:
            n += 1
        return n

    @property
    def num_examples(self):
        return len(self.images)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        idx = np.arange(len(self.images))
        if self.shuffle:
            rng.shuffle(idx)
        end = (len(idx) - len(idx) % self.batch_size if self.drop_last
               else len(idx))
        for i in range(0, end, self.batch_size):
            sel = idx[i:i + self.batch_size]
            x = self.images[sel]
            if self.raw:
                pass
            elif self.train_augment:
                x = augment_normalize(x, rng, self.pad, self.random_crop)
            else:
                x = normalize(x)
            yield {"image": x, "label": self.labels[sel]}


class CyclingIterator:
    """Endless batch stream for the trigger set (trainer.py:115-126)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self._it = iter(loader)

    def next(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


def prepare_dataset(args: Dict) -> Tuple[DataLoader, DataLoader]:
    """(train_loader, test_loader) per the reference's prepare_dataset, for
    'synthetic', 'cifar10' and 'cifar100'. With ``transfer_learning`` set
    the set is ``tl_dataset`` and the train transform drops the random crop
    (flip and normalization only, dataset.py:282-284)."""
    is_tl = bool(args.get("transfer_learning"))
    ds = args["tl_dataset"] if is_tl else args["dataset"]
    bs = args["batch_size"]
    if ds == "synthetic":
        tx, ty, vx, vy = synthetic_dataset(
            num_train=args.get("synthetic_train", 2048),
            num_test=args.get("synthetic_test", 512))
    elif ds in ("cifar10", "cifar100"):
        tx, ty, vx, vy = load_cifar(
            os.path.join(args.get("data_root", "data"), ds), ds)
    elif ds in ("caltech-101", "caltech-256", "imagenet1000"):
        raise NotImplementedError(
            f"dataset {ds!r} is not ported yet (ROADMAP queue 1, item 6: "
            "the Caltech and ImageNet loaders)")
    else:
        raise ValueError(f"unknown dataset {ds}")

    raw = bool(args.get("device_augment"))
    train_loader = DataLoader(tx, ty, bs, shuffle=True, train_augment=not raw,
                              random_crop=not is_tl, drop_last=True,
                              seed=args.get("seed", 0), raw=raw)
    test_loader = DataLoader(vx, vy, bs * 2)
    return train_loader, test_loader


def prepare_wm(datapath: str = "data/trigger_set/pics", crop: int = 32,
               shuffle: bool = True, seed: int = 0,
               raw: bool = False) -> DataLoader:
    """Trigger-set loader: WatermarkNN layout (``datapath`` of images beside
    ``labels-cifar.txt``), center-cropped, batch 2, drop_last. Reads local
    files only; imports PIL when called."""
    from PIL import Image

    labelpath = os.path.join(os.path.dirname(datapath), "labels-cifar.txt")
    if not os.path.exists(labelpath) or not os.path.isdir(datapath):
        raise FileNotFoundError(
            f"Trigger set not found: {datapath} with {labelpath} (the "
            "WatermarkNN layout, pics/ + labels-cifar.txt)")
    labels = np.loadtxt(labelpath).astype(np.int32)

    # labels-cifar.txt line i belongs to trigger image i; sort numerically
    # when the file stems are numbers (1.jpg, 2.jpg, ..., 10.jpg)
    def order(fn):
        stem = os.path.splitext(fn)[0]
        return (0, int(stem), fn) if stem.isdigit() else (1, 0, fn)

    files = sorted(os.listdir(datapath), key=order)
    if len(files) > len(labels):
        raise ValueError(f"trigger set mismatch: {len(files)} images in "
                         f"{datapath} but only {len(labels)} labels in "
                         f"{labelpath}")
    xs = []
    for fn in files:
        img = Image.open(os.path.join(datapath, fn)).convert("RGB")
        w, h = img.size
        left, top = (w - crop) // 2, (h - crop) // 2
        img = img.crop((left, top, left + crop, top + crop))
        xs.append(np.asarray(img, np.uint8))
    return DataLoader(np.stack(xs), labels[: len(xs)], batch_size=2,
                      shuffle=shuffle, drop_last=True, seed=seed, raw=raw)
