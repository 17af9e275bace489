"""The port's host data path against the JAX package's, on the CPU.

``deepipr_tpu_torch/data/{datasets,acquire}.py`` against
``deepipr_tpu/data/{datasets,acquire}.py`` on folders and archives written
here by PIL and the repository's data writers (tools/make_imagefolder.py,
tools/make_cifar_archive.py): every loader's arrays and batches bit for
bit. Both packages normalize in native C++ (data/native.py), a float32
rounding apart from their NumPy paths: the ``numpy_jax`` tests switch both
to the NumPy path (the port's plain versions), and the streaming and
``prepare_dataset`` tests run again with both native paths as they are.
Then the experiment on a tiny ImageNet folder and a tiny Caltech one: the
same ``_batches()`` as the JAX package's experiment, and one epoch
trained.
"""

from __future__ import annotations

import os
import shutil
import sys
import tarfile
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from deepipr_tpu.data import acquire as jax_acquire
from deepipr_tpu.data import datasets as jax_datasets
from deepipr_tpu.data import native as jax_native

from deepipr_tpu_torch.data import acquire, datasets, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_cifar_archive  # noqa: E402
import make_imagefolder  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread per test, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def numpy_jax(monkeypatch):
    """Both packages' NumPy paths in place of their native C++ ones: the
    JAX package's native entry points off, the port's plain versions in
    place of its native functions."""
    monkeypatch.setattr(jax_native, "normalize_native", lambda *a: None)
    monkeypatch.setattr(jax_native, "augment_normalize_native",
                        lambda *a: None)
    monkeypatch.setattr(native, "normalize_native", native.normalize_plain)
    monkeypatch.setattr(native, "augment_normalize_native",
                        native.augment_normalize_plain)


# ------------------------------------------------------------- writers

def write_class_folders(root, classes=3, per_class=5, seed=0):
    """``root/class_<i>/<j>.jpg|png``: JPEGs and PNGs of several aspect
    ratios, landscape and portrait, so every resize branch runs."""
    rng = np.random.default_rng(seed)
    shapes = [(40, 52), (57, 38), (36, 36), (90, 70), (33, 47)]
    for c in range(classes):
        d = os.path.join(root, f"class_{c:03d}")
        os.makedirs(d, exist_ok=True)
        for j in range(per_class):
            h, w = shapes[(c + j) % len(shapes)]
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = "png" if j % 2 else "jpg"
            Image.fromarray(arr).save(os.path.join(d, f"{j:03d}.{ext}"))
    return str(root)


def write_imagenet(data_root, classes=2, per_class=6, val_per_class=3,
                   size=72):
    """``data_root/ILSVRC2012/{train,val}`` by tools/make_imagefolder.py."""
    base = os.path.join(str(data_root), "ILSVRC2012")
    make_imagefolder.write_split(base, "train", classes, per_class, 0, size,
                                 90)
    make_imagefolder.write_split(base, "val", classes, val_per_class, 0,
                                 size, 90)
    return base


def write_trigger_tree(base, n=6, nested=True):
    """The WatermarkNN layout, pics/<i>.jpg + labels-cifar.txt, under
    ``base`` (as a repository checkout's data/trigger_set/ if
    ``nested``); returns the directory to archive."""
    rng = np.random.default_rng(2)
    root = (os.path.join(base, "WatermarkNN-master", "data", "trigger_set")
            if nested else base)
    pics = os.path.join(root, "pics")
    os.makedirs(pics)
    for i in range(1, n + 1):
        arr = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(pics, f"{i}.jpg"))
    np.savetxt(os.path.join(root, "labels-cifar.txt"),
               rng.integers(0, 10, n)[:, None], fmt="%d")
    return os.path.join(base, "WatermarkNN-master") if nested else root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_class_folders(tmp_path_factory.mktemp("folder"))


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    data_root = tmp_path_factory.mktemp("imagenet")
    write_imagenet(data_root)
    return str(data_root)


def assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def assert_same_batches(got_loader, want_loader, epochs=1):
    for _ in range(epochs):
        got = list(got_loader)
        want = (want_loader if isinstance(want_loader, list)
                else list(want_loader))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------------- loaders

@pytest.mark.parametrize("center_crop", [True, False])
def test_load_image_folder_matches_jax(folder, center_crop):
    kw = dict(size=24, center_crop=center_crop)
    assert_same_arrays(datasets.load_image_folder(folder, **kw),
                       jax_datasets.load_image_folder(folder, **kw))


@pytest.mark.parametrize("split", ["shuffled", "reference"])
def test_load_caltech_matches_jax(folder, split):
    got = datasets.load_caltech(folder, 3, split=split)
    assert_same_arrays(got, jax_datasets.load_caltech(folder, 3,
                                                      split=split))
    assert got[0].shape[1:] == (32, 32, 3) and len(got[0]) == 3 * 4


def test_load_caltech_refuses_an_unknown_split(folder):
    with pytest.raises(ValueError, match="unknown split"):
        datasets.load_caltech(folder, 3, split="random")


def test_resize_and_crop_draws_match_jax():
    img = Image.fromarray(np.zeros((37, 91, 3), np.uint8))
    for target in (16, 37, 50):
        assert datasets._short_side_resize(img, target).size == \
            jax_datasets._short_side_resize(img, target).size
    for h, w in [(256, 341), (341, 256), (256, 256), (10, 200), (200, 10),
                 (1, 1)]:
        for seed in range(20):
            got = datasets._random_resized_crop_params(
                np.random.default_rng(seed), h, w)
            want = jax_datasets._random_resized_crop_params(
                np.random.default_rng(seed), h, w)
            assert got == want


STREAMS = {
    "eval": dict(train=False),
    "eval raw": dict(train=False, raw=True),
    "train": dict(train=True, shuffle=True, drop_last=True),
    "train raw": dict(train=True, shuffle=True, drop_last=True, raw=True),
    "train full decode": dict(train=True, shuffle=True, draft=False),
}


def _streams_match(imagenet, name):
    root = os.path.join(imagenet, "ILSVRC2012", "train")
    kw = dict(batch_size=4, size=16, seed=3, workers=2, **STREAMS[name])
    got = datasets.StreamingImageFolder(root, **kw)
    want = jax_datasets.StreamingImageFolder(root, **kw)
    assert (len(got), got.num_examples, got.classes) == \
        (len(want), want.num_examples, want.classes)
    assert_same_batches(got, want, epochs=2)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streaming_image_folder_matches_jax(imagenet, numpy_jax, name):
    _streams_match(imagenet, name)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streaming_image_folder_native_matches_jax(imagenet, name):
    """Both packages' native normalize as they are: the same bytes."""
    calls = native.normalize_native.calls
    _streams_match(imagenet, name)
    assert (native.normalize_native.calls > calls) == ("raw" not in name)


def test_streaming_raw_pixels_match_jax_native_path(imagenet):
    """The uint8 pixels with the JAX package's native path as it is."""
    root = os.path.join(imagenet, "ILSVRC2012", "val")
    kw = dict(batch_size=4, size=16, workers=2, raw=True)
    assert_same_batches(datasets.StreamingImageFolder(root, **kw),
                        jax_datasets.StreamingImageFolder(root, **kw))


def test_streaming_draft_decodes_as_jax(imagenet):
    """72-px JPEGs at an 18-px decode size: PIL's draft decodes at 1/2
    scale, and its pixels differ from the full decode's."""
    root = os.path.join(imagenet, "ILSVRC2012", "val")
    kw = dict(batch_size=6, size=16, workers=1, raw=True)
    draft = list(datasets.StreamingImageFolder(root, draft=True, **kw))
    full = list(datasets.StreamingImageFolder(root, draft=False, **kw))
    assert not np.array_equal(draft[0]["image"], full[0]["image"])
    for d in (True, False):
        assert_same_batches(
            datasets.StreamingImageFolder(root, draft=d, **kw),
            jax_datasets.StreamingImageFolder(root, draft=d, **kw))


def test_streaming_cache_hits_match_jax(imagenet, tmp_path, monkeypatch,
                                        numpy_jax):
    """A first epoch fills the cache, in a tree of its own per (draft,
    decode size); the second decodes nothing and yields JAX's second."""
    root = os.path.join(imagenet, "ILSVRC2012", "train")
    kw = dict(batch_size=4, size=16, workers=2, train=True, shuffle=True,
              seed=1)
    cache = str(tmp_path / "cache")
    got = datasets.StreamingImageFolder(root, cache_dir=cache, **kw)
    list(got)
    assert sorted(os.listdir(cache)) == ["draft18"]
    assert datasets.StreamingImageFolder(
        root, cache_dir=cache, draft=False, **kw).cache_dir == \
        os.path.join(cache, "full18")
    want = jax_datasets.StreamingImageFolder(root, **kw)
    want.epoch = 1
    want = list(want)
    opened = []
    real_open = Image.open
    monkeypatch.setattr(Image, "open",
                        lambda *a, **k: opened.append(a) or real_open(*a, **k))
    assert_same_batches(got, want)
    assert opened == []


def test_streaming_two_shards_over_two_epochs_match_jax(imagenet, numpy_jax):
    root = os.path.join(imagenet, "ILSVRC2012", "train")
    for shard in (0, 1):
        kw = dict(batch_size=2, size=16, workers=2, train=True, shuffle=True,
                  drop_last=True, seed=5, num_shards=2, shard_id=shard,
                  raw=True)
        got = datasets.StreamingImageFolder(root, **kw)
        want = jax_datasets.StreamingImageFolder(root, **kw)
        assert (len(got), got.num_examples) == (len(want), want.num_examples)
        assert_same_batches(got, want, epochs=2)
    with pytest.raises(ValueError, match="shard_id"):
        datasets.StreamingImageFolder(root, 2, num_shards=2, shard_id=2)


# ---------------------------------------------------- prepare_dataset

def prepare_args(data_root, dataset, **over):
    args = {"dataset": dataset, "tl_dataset": dataset, "batch_size": 4,
            "data_root": str(data_root), "seed": 2, "synthetic_train": 16,
            "synthetic_test": 8, "workers": 2}
    args.update(over)
    return args


@pytest.fixture(scope="module")
def data_root(tmp_path_factory, imagenet):
    """CIFAR-10/100 archives by tools/make_cifar_archive.py, Caltech-101 as
    the reference's archive and Caltech-256 as flat class folders, beside
    the ImageNet folder."""
    root = tmp_path_factory.mktemp("data")
    for name in ("cifar10", "cifar100"):
        make_cifar_archive.main(["--name", name, "--out",
                                 str(root / name), "--train", "40",
                                 "--test", "10"])
    stage = root / "_stage"
    write_class_folders(str(stage / "101_ObjectCategories"), classes=3)
    os.makedirs(root / "caltech-101")
    with tarfile.open(root / "caltech-101" / "101_ObjectCategories.tar.gz",
                      "w:gz") as tar:
        tar.add(stage / "101_ObjectCategories",
                arcname="101_ObjectCategories")
    shutil.rmtree(stage)
    write_class_folders(str(root / "caltech-256"), classes=4, seed=1)
    shutil.copytree(os.path.join(imagenet, "ILSVRC2012"),
                    root / "ILSVRC2012")
    return root


PREPARED = {
    "synthetic": {}, "cifar10": {}, "cifar100": {}, "caltech-101": {},
    "caltech-101 reference split": {"caltech_split": "reference"},
    "caltech-256": {}, "imagenet1000": {},
    "imagenet1000 device augment": {"device_augment": True},
    "imagenet1000 transfer learning": {"transfer_learning": True},
    "caltech-256 device augment": {"device_augment": True},
    "caltech-101 transfer learning": {"transfer_learning": True},
}


def _prepared_match(data_root, name):
    args = prepare_args(data_root, name.split()[0], **PREPARED[name])
    got_train, got_test = datasets.prepare_dataset(args)
    want_train, want_test = jax_datasets.prepare_dataset(args)
    assert type(got_train).__name__ == type(want_train).__name__
    assert len(got_train) == len(want_train)
    assert_same_batches(got_train, want_train, epochs=2)
    assert_same_batches(got_test, want_test)


@pytest.mark.parametrize("name", sorted(PREPARED))
def test_prepare_dataset_matches_jax(data_root, numpy_jax, name):
    """Every dataset name, from the same files, through both packages'
    prepare_dataset: the same loaders' batches, two training epochs."""
    _prepared_match(data_root, name)


@pytest.mark.parametrize("name", sorted(PREPARED))
def test_prepare_dataset_native_matches_jax(data_root, name):
    """As ``test_prepare_dataset_matches_jax`` with both packages'
    native C++ as they are: the same bytes, through the native path."""
    calls = native.normalize_native.calls
    _prepared_match(data_root, name)
    assert native.normalize_native.calls > calls


def test_prepare_dataset_refuses_download_and_multihost(tmp_path, published,
                                                      numpy_jax):
    """--download fetches: ``prepare_dataset`` with download on a data
    root without CIFAR-10 fetches the archive from its (``file://``) URL,
    extracts it and loads it, batch for batch as the JAX package's
    ``prepare_dataset`` loads the extracted set. (--multihost is no
    refusal either: under it ImageNet streams this rank's share, the next
    test.)"""
    root = tmp_path / "fresh"
    args = prepare_args(root, "cifar10", download=True)
    got_train, got_test = datasets.prepare_dataset(args)
    assert os.path.exists(root / "cifar10" / "cifar-10-python.tar.gz")
    want_train, want_test = jax_datasets.prepare_dataset(
        {**args, "download": False})
    assert_same_batches(got_train, want_train, epochs=2)
    assert_same_batches(got_test, want_test)


def test_imagenet_multihost_reads_the_strided_share(data_root, numpy_jax,
                                                    monkeypatch):
    """Rank 1 of a 2-rank world streams the strided share of the training
    folder that JAX's process 1 of 2 streams (datasets.py:557-567), batch
    for batch; the validation stream stays whole."""
    import jax

    from deepipr_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "world", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    args = prepare_args(data_root, "imagenet1000", multihost=True)
    got_train, got_test = datasets.prepare_dataset(args)
    want_train, want_test = jax_datasets.prepare_dataset(args)
    assert (got_train.num_shards, got_train.shard_id) == (2, 1)
    assert (got_test.num_shards, got_test.shard_id) == (1, 0)
    assert len(got_train) == len(want_train)
    assert_same_batches(got_train, want_train)
    assert_same_batches(got_test, want_test)


def test_missing_caltech_names_what_to_place(tmp_path):
    with pytest.raises(FileNotFoundError, match="reference archive"):
        datasets.prepare_dataset(prepare_args(tmp_path, "caltech-101"))


# -------------------------------------------------------- trigger set

def _tarball(tmp_path):
    stage = tmp_path / "_stage"
    repo = write_trigger_tree(str(stage), nested=True)
    base = tmp_path / "trigger_set"
    base.mkdir()
    with tarfile.open(base / "WatermarkNN.tar.gz", "w:gz") as tar:
        tar.add(repo, arcname="WatermarkNN-master")
        # the rest of a repository checkout, which is not extracted
        readme = stage / "README.md"
        readme.write_text("x")
        tar.add(readme, arcname="WatermarkNN-master/README.md")
    shutil.rmtree(stage)
    return base


def _zip(tmp_path):
    stage = tmp_path / "_stage"
    write_trigger_tree(str(stage), nested=False)
    with zipfile.ZipFile(tmp_path / "trigger_set.zip", "w") as zf:
        for p in sorted(stage.rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(stage))
    shutil.rmtree(stage)
    return tmp_path / "trigger_set"


@pytest.mark.parametrize("archive", ["repo tarball", "zip"])
def test_prepare_wm_from_an_archive_matches_jax(tmp_path, numpy_jax,
                                                archive):
    """The archive extracted by the port, then read by both packages; and
    extracted by the JAX package in a twin directory: the same trees."""
    make = _tarball if archive == "repo tarball" else _zip
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir(), theirs.mkdir()
    base, twin = make(ours), make(theirs)
    got = datasets.prepare_wm(str(base / "pics"), crop=32, shuffle=True,
                              seed=4)
    want = jax_datasets.prepare_wm(str(twin / "pics"), crop=32,
                                   shuffle=True, seed=4)
    assert_same_batches(got, want, epochs=2)
    assert not any("README" in f for _, _, fs in os.walk(base) for f in fs)
    tree = sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)
    assert tree == sorted(os.path.relpath(os.path.join(d, f), twin)
                          for d, _, fs in os.walk(twin) for f in fs)


def test_trigger_set_lookups_match_jax(tmp_path):
    """The nested and flat layouts, the shallowest of two, and a foreign
    archive of a trigger-set name passed over with a warning."""
    deep = tmp_path / "a" / "x" / "y"
    write_trigger_tree(str(deep), nested=False)
    write_trigger_tree(str(tmp_path / "a" / "z"), nested=False)
    assert acquire._find_trigger_set(str(tmp_path / "a")) == \
        jax_acquire._find_trigger_set(str(tmp_path / "a"))
    base = tmp_path / "b"
    base.mkdir()
    with tarfile.open(base / "master.tar.gz", "w:gz") as tar:
        note = tmp_path / "note.txt"
        note.write_text("x")
        tar.add(note, arcname="other/note.txt")
    assert not acquire._archive_has_trigger_set(str(base / "master.tar.gz"))
    with pytest.warns(UserWarning, match="ignoring it"):
        assert acquire.locate_trigger_set(str(base)) is None
    assert os.listdir(base) == ["master.tar.gz"]


def test_missing_trigger_set_names_the_layout(tmp_path):
    with pytest.raises(FileNotFoundError, match="labels-cifar.txt"):
        datasets.prepare_wm(str(tmp_path / "trigger_set" / "pics"))


# --------------------------------------------------------- archives

def _tar_with(tmp_path, member: tarfile.TarInfo, data=b""):
    path = tmp_path / "evil.tar"
    import io

    with tarfile.open(path, "w") as tar:
        member.size = len(data)
        tar.addfile(member, io.BytesIO(data) if data else None)
    return str(path)


def _sym(name, target):
    m = tarfile.TarInfo(name)
    m.type, m.linkname = tarfile.SYMTYPE, target
    return m


def _dev(name):
    m = tarfile.TarInfo(name)
    m.type = tarfile.CHRTYPE
    return m


UNSAFE_TAR = {
    "parent path": lambda: tarfile.TarInfo("../escape.txt"),
    "absolute path": lambda: tarfile.TarInfo("/tmp/escape.txt"),
    "escaping symlink": lambda: _sym("link", "../../etc"),
    "absolute symlink": lambda: _sym("link", "/etc/passwd"),
    "device": lambda: _dev("dev0"),
}


@pytest.mark.parametrize("name", sorted(UNSAFE_TAR))
def test_unsafe_tar_members_are_refused(tmp_path, name):
    path = _tar_with(tmp_path, UNSAFE_TAR[name](),
                     b"x" if "path" in name else b"")
    dest = tmp_path / "dest"
    dest.mkdir()
    with pytest.raises(ValueError, match="unsafe|device"):
        acquire.extract_archive(path, str(dest))
    with pytest.raises(ValueError, match="unsafe|device"):
        jax_acquire.extract_archive(path, str(dest))
    assert os.listdir(dest) == []


@pytest.mark.parametrize("member", ["../escape.txt", "a/../../escape.txt"])
def test_unsafe_zip_members_are_refused(tmp_path, member):
    path = tmp_path / "evil.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("ok.txt", "fine")
        zf.writestr(member, "bad")
    dest = tmp_path / "dest"
    dest.mkdir()
    with pytest.raises(ValueError, match="unsafe"):
        acquire.extract_archive(str(path), str(dest))
    assert os.listdir(dest) == []


def test_archive_specs_match_jax():
    assert acquire.ARCHIVES == {k: acquire.ArchiveSpec(**vars(v))
                                for k, v in jax_acquire.ARCHIVES.items()}
    assert vars(acquire.WATERMARKNN) == vars(jax_acquire.WATERMARKNN)
    assert acquire._WM_ARCHIVE_NAMES == jax_acquire._WM_ARCHIVE_NAMES


def test_locate_caltech_prefers_the_archive_over_a_stray_dir(tmp_path):
    root = tmp_path / "caltech-101"
    write_class_folders(str(tmp_path / "_s" / "101_ObjectCategories"), 2, 2)
    root.mkdir()
    with tarfile.open(root / "101_ObjectCategories.tar.gz", "w:gz") as tar:
        tar.add(tmp_path / "_s" / "101_ObjectCategories",
                arcname="101_ObjectCategories")
    (root / "stray").mkdir()
    got = acquire.locate_caltech(str(root), "caltech-101")
    assert got == str(root / "101_ObjectCategories")
    assert got == jax_acquire.locate_caltech(str(root), "caltech-101")
    assert acquire.locate_caltech(str(tmp_path / "none"),
                                  "caltech-256") is None


def test_locate_cifar_extracts_a_placed_archive(tmp_path):
    make_cifar_archive.main(["--name", "cifar10", "--out",
                             str(tmp_path / "cifar10"), "--train", "20",
                             "--test", "5"])
    assert acquire.locate_cifar(str(tmp_path / "cifar10"),
                                "cifar10") == str(tmp_path / "cifar10")
    assert os.path.isdir(tmp_path / "cifar10" / "cifar-10-batches-py")
    assert acquire.locate_cifar(str(tmp_path / "x"), "cifar100") is None
    with pytest.raises(FileNotFoundError, match="Place the archive"):
        acquire.prepare_archive(str(tmp_path / "x"), "cifar100")


def write_trigger_set(root, num=4, seed=0):
    """``root/{pics/<i>.png, labels-cifar.txt}``: the WatermarkNN layout."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pics"), exist_ok=True)
    for i in range(num):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "pics", f"{i:03d}.png"))
    np.savetxt(os.path.join(root, "labels-cifar.txt"),
               rng.integers(0, 10, num), fmt="%d")
    return str(root)


def _tar(path, folder, arcname):
    with tarfile.open(path, "w:gz" if path.endswith(".gz") else "w") as tar:
        tar.add(folder, arcname=arcname)
    return path


@pytest.fixture
def published(tmp_path, monkeypatch):
    """The archives ``acquire`` fetches, written here and published as
    ``file://`` URLs: CIFAR-10 (tools/make_cifar_archive.py), a
    Caltech-101 tarball of class folders, and a WatermarkNN repository
    tarball holding data/trigger_set/. ``acquire.ARCHIVES`` and
    ``acquire.WATERMARKNN`` name those URLs; nothing reaches a network.
    Returns {name: archive path}."""
    import dataclasses

    src = tmp_path / "published"
    make_cifar_archive.main(["--name", "cifar10", "--out", str(src),
                             "--train", "20", "--test", "5"])
    write_class_folders(str(src / "stage" / "101_ObjectCategories"))
    write_trigger_set(str(src / "stage" / "WatermarkNN-master" / "data"
                          / "trigger_set"))
    paths = {
        "cifar10": str(src / "cifar-10-python.tar.gz"),
        "caltech-101": _tar(str(src / "101_ObjectCategories.tar.gz"),
                            str(src / "stage" / "101_ObjectCategories"),
                            "101_ObjectCategories"),
        "watermarknn": _tar(str(src / "WatermarkNN.tar.gz"),
                            str(src / "stage" / "WatermarkNN-master"),
                            "WatermarkNN-master"),
    }
    for name in ("cifar10", "caltech-101"):
        monkeypatch.setitem(acquire.ARCHIVES, name, dataclasses.replace(
            acquire.ARCHIVES[name], url=f"file://{paths[name]}"))
    monkeypatch.setattr(acquire, "WATERMARKNN", dataclasses.replace(
        acquire.WATERMARKNN, url=f"file://{paths['watermarknn']}"))
    return paths


@pytest.mark.parametrize("call", [
    lambda d: acquire.prepare_archive(d, "caltech-101", allow_download=True),
    lambda d: acquire.locate_caltech(d, "caltech-101", allow_download=True),
    lambda d: acquire.locate_cifar(d, "cifar10", allow_download=True),
    lambda d: acquire.locate_trigger_set(d, allow_download=True),
    lambda d: datasets.prepare_wm(os.path.join(d, "t", "pics"),
                                  allow_download=True),
], ids=["prepare_archive", "locate_caltech", "locate_cifar",
        "locate_trigger_set", "prepare_wm"])
def test_allow_download_is_refused(tmp_path, published, numpy_jax, call):
    """Each entry point under allow_download=True, on an empty directory:
    the archive is fetched from its (``file://``) URL into the directory
    and extracted there, and what it returns is what the JAX package's
    counterpart returns from the same directory afterwards (prepare_wm:
    the same batches)."""
    d = str(tmp_path / "data")
    got = call(d)
    fetched = [f for _, _, files in os.walk(d) for f in files
               if f.endswith(".tar.gz")]
    assert len(fetched) == 1, fetched
    if isinstance(got, datasets.DataLoader):
        assert_same_batches(got, jax_datasets.prepare_wm(
            os.path.join(d, "t", "pics")))
    elif isinstance(got, tuple):
        assert got == jax_acquire.locate_trigger_set(d)
        assert sorted(os.listdir(got[0])) == [f"{i:03d}.png"
                                              for i in range(4)]
    elif got.endswith("101_ObjectCategories"):
        assert got == jax_acquire.locate_caltech(d, "caltech-101")
        assert sorted(os.listdir(got)) == [f"class_{c:03d}"
                                           for c in range(3)]
    else:
        assert got == jax_acquire.locate_cifar(d, "cifar10") == d
        assert os.path.isdir(os.path.join(d, "cifar-10-batches-py"))


# ------------------------------------------------------ the experiment

def experiment_args(data_root, logdir, dataset, **over):
    from deepipr_tpu_torch.cli import train_v1

    args = vars(train_v1.build_parser().parse_args([]))
    imagenet = dataset == "imagenet1000"
    args.update({"arch": "alexnet" if imagenet else "resnet9",
                 "dataset": dataset, "batch_size": 4,
                 "epochs": 1, "lr_config": "lr_configs/finetune.json",
                 "passport_config": "passport_configs/resnet9_passport.json",
                 "data_root": str(data_root), "logdir": str(logdir),
                 "workers": 2})
    args.update(over)
    return args


EXPERIMENTS = {
    "imagenet1000": {},
    "imagenet1000 device augment": {"device_augment": True},
    "caltech-256": {},
    "caltech-256 device augment": {"device_augment": True},
    "caltech-256 epoch scan": {"epoch_scan": True},
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_experiment_batches_match_jax_and_train(data_root, tmp_path,
                                                numpy_jax, name):
    """A CPU ClassificationExperiment's ``_batches()`` against the JAX
    package's experiment's on the same files, then one epoch trained
    (AlexNet's ImageNet head with its dropout on ImageNet, under
    --device-augment through K1's plain version at pad 0 with zero
    draws; ResNet9 on Caltech, --epoch-scan keeping its set resident)."""
    from deepipr_tpu.train.experiment import (
        ClassificationExperiment as JaxExperiment,
    )

    from deepipr_tpu_torch.train.experiment import ClassificationExperiment

    dataset = name.split()[0]
    args = experiment_args(data_root, tmp_path / "port", dataset,
                           **EXPERIMENTS[name])
    exp = ClassificationExperiment(args, device="cpu")
    jexp = JaxExperiment({**args, "logdir": str(tmp_path / "jax"),
                          "use_mesh": False})
    got, want = list(exp._batches()), list(jexp._batches())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    metrics = exp._train_epoch(1)
    assert np.isfinite(metrics["loss"]) and metrics["images_per_sec"] > 0
    # the resident epoch (Caltech's 32 px set, as CIFAR) or the prefetched
    # host-fed one
    assert (exp.epoch_fn is not None) == bool(args["epoch_scan"])
    assert len(exp.prefetch_stats.get("host_s", ())) == \
        (0 if args["epoch_scan"] else len(got))
    assert exp.imgcrop == (224 if dataset == "imagenet1000" else 32)


@pytest.fixture(scope="module")
def v2_checkpoint(tmp_path_factory):
    """A one-epoch ResNet9 V2 run on the synthetic set, through the CLI."""
    from deepipr_tpu_torch.cli import train_v23

    logdir = tmp_path_factory.mktemp("v2")
    run = train_v23.main(
        ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size", "8",
         "--epochs", "1", "--passport-config",
         "passport_configs/resnet9_passport.json", "--lr-config",
         "lr_configs/finetune.json", "--key-type", "random", "--logdir",
         str(logdir)], device="cpu", synthetic_train=16, synthetic_test=8)
    return os.path.join(run.logdir, "models", "best.ckpt")


@pytest.mark.parametrize("tl_dataset", ["caltech-101", "caltech-256",
                                        "imagenet1000"])
def test_transfer_learning_onto_caltech_and_imagenet(data_root, tmp_path,
                                                     v2_checkpoint,
                                                     tl_dataset):
    """--tl-dataset caltech-*/imagenet1000 through the CLI: the host path
    without prefetch, as the JAX package's TL loop; one row of the
    survival columns."""
    import csv

    from deepipr_tpu_torch.cli import train_v23
    from deepipr_tpu_torch.train import experiment

    used = []
    real = experiment.prefetch
    experiment.prefetch = lambda *a, **k: used.append(a) or real(*a, **k)
    try:
        exp = train_v23.main(
            ["--arch", "resnet9", "--dataset", "synthetic", "--batch-size",
             "8", "--epochs", "1", "--passport-config",
             "passport_configs/resnet9_passport.json", "--lr-config",
             "lr_configs/finetune.json", "--logdir", str(tmp_path),
             "--data-root", str(data_root), "--workers", "2",
             "--transfer-learning", "--tl-dataset", tl_dataset,
             "--pretrained-path", v2_checkpoint],
            device="cpu", synthetic_train=16, synthetic_test=8)
    finally:
        experiment.prefetch = real
    assert used == []
    with open(os.path.join(exp.logdir, "tl_1", "history.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    survival = [k for k in rows[0] if k.startswith("old_wm_passport_")]
    assert survival and {"epoch", "train_loss", "valid_acc"} <= set(rows[0])
    assert all(np.isfinite(float(v)) for v in rows[0].values())
