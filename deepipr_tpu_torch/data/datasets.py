"""Data pipeline: CIFAR / Caltech / ImageNet / trigger set / synthetic.

Counterpart of ``deepipr_tpu/data/datasets.py``, kept as a copy: the port
imports nothing of the JAX package. The reference's semantics
(dataset.py): train transforms RandomCrop(pad = 4/32 * size) +
RandomHorizontalFlip + ImageNet normalization (:268-293), the crop dropped
in transfer-learning mode (:282-284); test transforms normalization only;
the trigger set (WatermarkNN folder + labels-cifar.txt, CenterCrop, batch 2,
drop_last) cycled onto training batches (:142-193). Batches are NumPy,
augmented and normalized on the host by the C++ of ``data/native.py``, as
the JAX package's are, draw for draw and byte for byte. Caltech is loaded
whole at 32 px (Resize+CenterCrop, the per-class 80/20 split, :14-139,
274-278); ImageNet is streamed from its class folders
(``StreamingImageFolder``, :196-243). Images decode with PIL, imported
when a loader is called.
Every set is read from local files, archives already on disk included
(``data/acquire.py``); under ``--download`` a missing archive is fetched
first.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Tuple

import numpy as np

from deepipr_tpu_torch.data import native

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


def _class_folders(root: str):
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def load_image_folder(root: str, size: int = 224, center_crop: bool = True,
                      resize_ratio: float = 256 / 224):
    """``root/<class>/<img>`` -> (N, size, size, 3) uint8 images, int32
    labels (class folders in sorted order) and the class names.

    center_crop=True: the short side scaled to ``int(size *
    resize_ratio)``, then a center crop to ``size`` (the reference's
    Resize+CenterCrop: ratio 256/224 for ImageNet eval, 1.0 for Caltech's
    Resize(32)+CenterCrop(32)); else a plain resize to size x size."""
    from PIL import Image

    classes = _class_folders(root)
    xs, ys = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fn in sorted(os.listdir(cdir)):
            img = Image.open(os.path.join(cdir, fn)).convert("RGB")
            if center_crop:
                scale = int(size * resize_ratio) / min(img.size)
                img = img.resize(
                    (max(size, round(img.size[0] * scale)),
                     max(size, round(img.size[1] * scale))))
                w, h = img.size
                left, top = (w - size) // 2, (h - size) // 2
                img = img.crop((left, top, left + size, top + size))
            else:
                img = img.resize((size, size))
            xs.append(np.asarray(img, np.uint8))
            ys.append(ci)
    return np.stack(xs), np.asarray(ys, np.int32), classes


def load_caltech(root: str, num_classes: int, size: int = 32, seed: int = 7,
                 split: str = "shuffled"):
    """Caltech-101/256 class folders under ``root`` -> (train x, train y,
    test x, test y) at ``size`` px (Resize+CenterCrop, dataset.py:274-278),
    cut 80/20 within each class (dataset.py:14-139).

    split="shuffled": each class shuffled from ``seed`` before the cut.
    split="reference": the reference's cut, the first 80 % of each class
    in sorted file order (dataset.py:57-61)."""
    x, y, _ = load_image_folder(root, size=size, center_crop=True,
                                resize_ratio=1.0)
    if split not in ("shuffled", "reference"):
        raise ValueError(f"unknown split {split!r}")
    rng = np.random.default_rng(seed)
    train_idx, test_idx = [], []
    for c in np.unique(y):
        idx = np.where(y == c)[0]
        if split == "shuffled":
            rng.shuffle(idx)
        k = int(0.8 * len(idx))
        train_idx.extend(idx[:k])
        test_idx.extend(idx[k:])
    train_idx, test_idx = np.asarray(train_idx), np.asarray(test_idx)
    return x[train_idx], y[train_idx], x[test_idx], y[test_idx]


def _short_side_resize(img, target: int):
    """The PIL image resized so its short side is ``target``, aspect kept."""
    w, h = img.size
    if min(w, h) == target:
        return img
    scale = target / min(w, h)
    return img.resize((max(target, round(w * scale)),
                       max(target, round(h * scale))))


def _random_resized_crop_params(rng, h: int, w: int):
    """(top, left, height, width) as torchvision's RandomResizedCrop draws
    them (the reference's ImageNet train transform, dataset.py:204-210):
    area scale U(0.08, 1), aspect ratio exp(U(log 3/4, log 4/3)), 10
    attempts, then a center crop clamped to the ratio range."""
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ratio)))
        ch = int(round(np.sqrt(target_area / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    in_ratio = w / h
    if in_ratio < 3 / 4:
        cw, ch = w, min(h, int(round(w / (3 / 4))))
    elif in_ratio > 4 / 3:
        ch, cw = h, min(w, int(round(h * (4 / 3))))
    else:
        ch, cw = h, w
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class StreamingImageFolder:
    """ImageFolder streamed batch by batch: O(batch) memory, decoded by a
    pool of threads (the reference streams ImageNet through DataLoader
    workers, dataset.py:196-243; decoded whole, ImageNet train would take
    about 190 GB of host memory).

    The paths ``root/<class>/<img>`` are indexed up front; each image is
    decoded when its batch is made:

    - decode: the short side resized to ``round(size * resize_ratio)``
      (256 for 224);
    - train: RandomResizedCrop(size) on the resized image, then a
      horizontal flip with probability 1/2 (dataset.py:204-210), the draws
      from ``(seed, epoch, index)``;
    - eval: a center crop to ``size`` (Resize(256)+CenterCrop(224),
      :213-218);
    - ``cache_dir``: the resized uint8 image kept as ``.npy``, so later
      epochs skip the decode, in a tree of its own for each (draft, decode
      size) pair (``draft256``, ``full256``, ...);
    - ``draft``: JPEG decode at 1/2, 1/4 or 1/8 scale where the source is
      that much larger than the decode size (PIL's ``draft``);
    - ``raw``: batches stay uint8 (the normalize then runs on the device);
      else they are normalized f32 NHWC;
    - ``num_shards``/``shard_id``: this reader's strided share of every
      epoch's permutation (which is the same on every reader).

    Yields {'image', 'label'} NumPy batches.
    """

    def __init__(self, root: str, batch_size: int, size: int = 224,
                 train: bool = False, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, workers: int = 16,
                 resize_ratio: float = 256 / 224, cache_dir: str = None,
                 num_shards: int = 1, shard_id: int = 0, raw: bool = False,
                 draft: bool = True):
        self.root = root
        self.batch_size = batch_size
        self.size = size
        self.train = train
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.workers = workers
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.decode_size = int(round(size * resize_ratio))
        self.cache_dir = (
            os.path.join(cache_dir,
                         f"{'draft' if draft else 'full'}{self.decode_size}")
            if cache_dir is not None else None)
        self.raw = raw
        self.draft = draft
        self.epoch = 0

        self.classes = _class_folders(root)
        if not self.classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.samples = []  # (path relative to root, label)
        for ci, cls in enumerate(self.classes):
            for fn in sorted(os.listdir(os.path.join(root, cls))):
                self.samples.append((os.path.join(cls, fn), ci))
        self.labels = np.asarray([lab for _, lab in self.samples], np.int32)

    def _shard_size(self):
        return len(range(self.shard_id, len(self.samples), self.num_shards))

    def __len__(self):
        n = self._shard_size() // self.batch_size
        if not self.drop_last and self._shard_size() % self.batch_size:
            n += 1
        return n

    @property
    def num_examples(self):
        return self._shard_size()

    def _decode_resized(self, rel: str) -> np.ndarray:
        """(H, W, 3) uint8 with the short side ``decode_size``, from the
        cache when it holds the image."""
        from PIL import Image

        if self.cache_dir is not None:
            cpath = os.path.join(self.cache_dir, rel + ".npy")
            if os.path.exists(cpath):
                return np.load(cpath)
        img = Image.open(os.path.join(self.root, rel))
        if self.draft:
            img.draft("RGB", (self.decode_size, self.decode_size))
        img = img.convert("RGB")
        arr = np.asarray(_short_side_resize(img, self.decode_size), np.uint8)
        if self.cache_dir is not None:
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            tmp = cpath + f".tmp{os.getpid()}.npy"  # atomic against others
            np.save(tmp, arr)
            os.replace(tmp, cpath)
        return arr

    def _example(self, idx: int, epoch: int) -> np.ndarray:
        """Example ``idx`` of ``epoch``, decoded and transformed to (size,
        size, 3) uint8."""
        from PIL import Image

        rel, _ = self.samples[idx]
        arr = self._decode_resized(rel)
        h, w = arr.shape[:2]
        if self.train:
            rng = np.random.default_rng((self.seed, epoch, idx))
            top, left, ch, cw = _random_resized_crop_params(rng, h, w)
            crop = arr[top:top + ch, left:left + cw]
            if (ch, cw) != (self.size, self.size):
                crop = np.asarray(
                    Image.fromarray(crop).resize((self.size, self.size)),
                    np.uint8)
            if rng.random() < 0.5:
                crop = crop[:, ::-1]
            return crop
        top, left = (h - self.size) // 2, (w - self.size) // 2
        return arr[top:top + self.size, left:left + self.size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        epoch = self.epoch
        self.epoch += 1
        rng = np.random.default_rng((self.seed, epoch))
        idx = np.arange(len(self.samples))
        if self.shuffle:
            rng.shuffle(idx)
        idx = idx[self.shard_id::self.num_shards]
        end = (len(idx) - len(idx) % self.batch_size if self.drop_last
               else len(idx))
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for i in range(0, end, self.batch_size):
                sel = idx[i:i + self.batch_size]
                batch = np.stack(list(pool.map(
                    lambda j: self._example(j, epoch), sel)))
                yield {"image": batch if self.raw else normalize(batch),
                       "label": self.labels[sel]}


def normalize(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> f32 NHWC, scaled to [0, 1] then ImageNet mean/std, in
    the native C++ (``data/native.py``) as the JAX package does."""
    return native.normalize_native(batch_u8, IMAGENET_MEAN, IMAGENET_STD)


def augment_normalize(batch_u8: np.ndarray, rng: np.random.Generator,
                      pad: int, random_crop: bool = True) -> np.ndarray:
    """Train transform: zero-pad random crop + hflip + normalization, with
    the JAX package's draws from ``rng`` (crop rows, crop columns, flips),
    in one pass of the native C++ (``data/native.py``) as that package
    does."""
    n = batch_u8.shape[0]
    crop_pad = pad if (random_crop and pad > 0) else 0
    if crop_pad:
        ys = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
        xs = rng.integers(0, 2 * pad + 1, n).astype(np.int32)
    else:
        ys = np.zeros(n, np.int32)
        xs = np.zeros(n, np.int32)
    flips = rng.random(n) < 0.5
    return native.augment_normalize_native(
        batch_u8, ys, xs, flips.astype(np.uint8), crop_pad, IMAGENET_MEAN,
        IMAGENET_STD)


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


def prepare_dataset(args: Dict):
    """(train_loader, test_loader) per the reference's prepare_dataset.
    With ``transfer_learning`` set the set is ``tl_dataset`` and the train
    transform drops the random crop (flip and normalization only,
    dataset.py:282-284; ImageNet's train stream then takes the eval
    transform). CIFAR and Caltech archives placed under ``data_root``
    are extracted there (``data/acquire.py``). ImageNet is streamed from
    ``data_root/ILSVRC2012/{train,val}`` (``StreamingImageFolder``), raw
    uint8 under ``device_augment``."""
    from deepipr_tpu_torch.data.acquire import locate_caltech, locate_cifar

    is_tl = bool(args.get("transfer_learning"))
    ds = args["tl_dataset"] if is_tl else args["dataset"]
    bs = args["batch_size"]
    root = args.get("data_root", "data")
    download = bool(args.get("download"))
    if ds == "synthetic":
        tx, ty, vx, vy = synthetic_dataset(
            num_train=args.get("synthetic_train", 2048),
            num_test=args.get("synthetic_test", 512))
    elif ds in ("cifar10", "cifar100"):
        croot = os.path.join(root, ds)
        locate_cifar(croot, ds, allow_download=download)
        tx, ty, vx, vy = load_cifar(croot, ds)
    elif ds in ("caltech-101", "caltech-256"):
        droot = locate_caltech(os.path.join(root, ds), ds,
                               allow_download=download)
        if droot is None:
            raise FileNotFoundError(
                f"{ds} not found under {os.path.join(root, ds)}; place the "
                "extracted class folders or the reference archive there, "
                "or pass --download (reference dataset.py:89-130)")
        tx, ty, vx, vy = load_caltech(
            droot, 101 if ds == "caltech-101" else 256,
            split=args.get("caltech_split", "shuffled"))
    elif ds == "imagenet1000":
        # under --multihost each rank streams its strided share (JAX
        # datasets.py:557-567)
        num_shards, shard_id = 1, 0
        if args.get("multihost"):
            from deepipr_tpu_torch.parallel.distributed import rank, world

            num_shards, shard_id = world(), rank()
        base = os.path.join(root, "ILSVRC2012")
        cache = args.get("imagenet_cache")
        workers = args.get("workers", 16)
        draft = bool(args.get("draft", True))
        train_loader = StreamingImageFolder(
            os.path.join(base, "train"), bs, train=not is_tl, shuffle=True,
            drop_last=True, seed=args.get("seed", 0), workers=workers,
            cache_dir=cache, num_shards=num_shards, shard_id=shard_id,
            raw=bool(args.get("device_augment")) and not is_tl, draft=draft)
        test_loader = StreamingImageFolder(
            os.path.join(base, "val"), bs * 2, train=False, workers=workers,
            cache_dir=cache, draft=draft)
        return train_loader, test_loader
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
               raw: bool = False, allow_download: bool = False) -> DataLoader:
    """Trigger-set loader: WatermarkNN layout (``datapath`` of images beside
    ``labels-cifar.txt``), center-cropped, batch 2, drop_last. Where that
    is not there, a trigger-set archive placed in its parent directory or
    above is extracted (``acquire.locate_trigger_set``), or under
    ``allow_download`` the WatermarkNN repository tarball is fetched and
    extracted. Imports PIL when called."""
    from PIL import Image

    labelpath = os.path.join(os.path.dirname(datapath), "labels-cifar.txt")
    if not os.path.exists(labelpath) or not os.path.isdir(datapath):
        from deepipr_tpu_torch.data.acquire import locate_trigger_set

        found = locate_trigger_set(os.path.dirname(datapath),
                                   allow_download=allow_download)
        if found is not None:
            datapath, labelpath = found
    if not os.path.exists(labelpath):
        raise FileNotFoundError(
            f"Trigger set not found: {datapath} with {labelpath} (the "
            "WatermarkNN layout, pics/ + labels-cifar.txt, or its "
            "repository tarball or zip to extract); "
            "tools/make_trigger_set.py writes an offline stand-in.")
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
