"""Dataset archives on local disk: location and hardened extraction.

Counterpart of the local half of ``deepipr_tpu/data/acquire.py``, kept as a
copy (the port imports nothing of the JAX package). The reference's Caltech
classes (dataset.py:14-139) untar ``101_ObjectCategories.tar.gz`` /
``256_ObjectCategories.tar`` into ``root`` before indexing
``root/<foldername>/<class>/<img>``; the port takes such an archive, or the
extracted tree, from where it was placed:

    data/caltech-101/101_ObjectCategories.tar.gz   -> extracted in place
    data/caltech-101/101_ObjectCategories/...      -> used directly

The same holds for the CIFAR archives and the WatermarkNN trigger set.
Nothing is downloaded: ``allow_download=True`` raises, as ``--download``
does. Extraction refuses absolute paths, ``..`` components, links that
escape the destination and device members.
"""

from __future__ import annotations

import os
import tarfile
import warnings
from dataclasses import dataclass
from typing import Optional

DOWNLOAD_REFUSED = ("--download is refused: the port reads datasets from "
                    "local files only and needs no network")


@dataclass(frozen=True)
class ArchiveSpec:
    """One dataset archive (reference dataset.py:15-17, 136-139): where it
    was published, its file name, and the folder it extracts to."""

    url: str
    filename: str
    foldername: str


ARCHIVES = {
    "caltech-101": ArchiveSpec(
        url="http://www.vision.caltech.edu/Image_Datasets/Caltech101/"
            "101_ObjectCategories.tar.gz",
        filename="101_ObjectCategories.tar.gz",
        foldername="101_ObjectCategories",
    ),
    "caltech-256": ArchiveSpec(
        url="http://www.vision.caltech.edu/Image_Datasets/Caltech256/"
            "256_ObjectCategories.tar",
        filename="256_ObjectCategories.tar",
        foldername="256_ObjectCategories",
    ),
    # torchvision's CIFAR archives (the reference loads CIFAR through
    # torchvision.datasets.CIFAR10/100, dataset.py:262-267)
    "cifar10": ArchiveSpec(
        url="https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
        filename="cifar-10-python.tar.gz",
        foldername="cifar-10-batches-py",
    ),
    "cifar100": ArchiveSpec(
        url="https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
        filename="cifar-100-python.tar.gz",
        foldername="cifar-100-python",
    ),
}

# The WatermarkNN trigger set (reference dataset.py:171-174): the repository
# tarball holds it at <repo>/data/trigger_set/{pics/, labels-cifar.txt}
WATERMARKNN = ArchiveSpec(
    url="https://github.com/adiyoss/WatermarkNN/archive/refs/heads/"
        "master.tar.gz",
    filename="WatermarkNN.tar.gz",
    foldername="WatermarkNN-master",
)

# archive names taken as a placed trigger set (in the trigger-set directory
# and its parent)
_WM_ARCHIVE_NAMES = (
    "trigger_set.tar.gz", "trigger_set.tar", "trigger_set.zip",
    "WatermarkNN.tar.gz", "WatermarkNN.zip", "master.tar.gz",
)


def _refuse_download(allow_download: bool) -> None:
    if allow_download:
        raise NotImplementedError(DOWNLOAD_REFUSED)


def _check_member(member: tarfile.TarInfo, dest: str) -> None:
    """Refuse a tar member that would write outside ``dest``."""
    target = os.path.realpath(os.path.join(dest, member.name))
    base = os.path.realpath(dest)
    if not (target == base or target.startswith(base + os.sep)):
        raise ValueError(f"unsafe archive member path: {member.name!r}")
    if member.islnk() or member.issym():
        link = os.path.realpath(os.path.join(os.path.dirname(target),
                                             member.linkname))
        if not link.startswith(base + os.sep):
            raise ValueError(f"unsafe archive link: {member.name!r} -> "
                             f"{member.linkname!r}")
    if member.isdev():
        raise ValueError(f"device member in archive: {member.name!r}")


def _check_zip_member(name: str, dest: str) -> None:
    """Refuse a zip member that would write outside ``dest``."""
    target = os.path.realpath(os.path.join(dest, name))
    base = os.path.realpath(dest)
    if not (target == base or target.startswith(base + os.sep)):
        raise ValueError(f"unsafe archive member path: {name!r}")


def extract_archive(archive_path: str, dest: str, *,
                    only_under: Optional[str] = None) -> None:
    """Extract a .tar / .tar.gz / .zip into ``dest`` (reference
    dataset.py:96-105), every member's path checked first.

    ``only_under``: extract only the members whose path holds this
    substring (``"/data/trigger_set/"`` keeps a WatermarkNN checkout's
    trigger set); everything when no member matches (a flat archive)."""
    def keep(name: str) -> bool:
        return only_under is None or only_under in "/" + name.replace(
            os.sep, "/")

    if archive_path.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(archive_path) as zf:
            names = [n for n in zf.namelist() if keep(n)] or zf.namelist()
            for name in names:
                _check_zip_member(name, dest)
            zf.extractall(dest, members=names)
        return
    mode = "r:gz" if archive_path.endswith(".gz") else "r"
    with tarfile.open(archive_path, mode) as tar:
        members = tar.getmembers()
        kept = [m for m in members if keep(m.name)] or members
        for m in kept:
            _check_member(m, dest)
        tar.extractall(dest, members=kept, filter="data")


def prepare_archive(root: str, name_or_spec, *,
                    allow_download: bool = False) -> str:
    """``root/<foldername>``, extracted from ``root/<filename>`` if it is
    not there yet (reference dataset.py:89-105); FileNotFoundError with
    placement instructions when neither is. ``name_or_spec``: an
    ``ARCHIVES`` key or an ``ArchiveSpec``."""
    _refuse_download(allow_download)
    spec = (ARCHIVES[name_or_spec] if isinstance(name_or_spec, str)
            else name_or_spec)
    folder = os.path.join(root, spec.foldername)
    if os.path.isdir(folder):
        return folder
    fpath = os.path.join(root, spec.filename)
    if not os.path.exists(fpath):
        raise FileNotFoundError(
            f"{folder} not found and {spec.filename} is not present in "
            f"{root}. Place the archive there (or the extracted "
            f"{spec.foldername}/ tree); it is published at {spec.url}.")
    extract_archive(fpath, root)
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"extracting {fpath} did not produce {folder}; archive layout "
            f"does not match the expected {spec.foldername}/ root")
    return folder


def locate_caltech(root: str, dataset: str, *,
                   allow_download: bool = False) -> Optional[str]:
    """The directory whose children are the class folders of a Caltech set
    under ``root`` (e.g. data/caltech-101): ``root/<foldername>`` (the
    reference's layout, dataset.py:43-48, extracted from its archive if
    needed), or ``root`` itself when it holds class folders and no archive.
    None when neither is there."""
    _refuse_download(allow_download)
    spec = ARCHIVES[dataset]
    if os.path.isdir(root):
        entries = os.listdir(root)
        if spec.foldername in entries and os.path.isdir(
                os.path.join(root, spec.foldername)):
            return os.path.join(root, spec.foldername)
        # a placed archive wins over a stray directory beside it (a tree
        # left half extracted)
        if (spec.filename not in entries
                and any(os.path.isdir(os.path.join(root, e))
                        for e in entries)):
            return root
    try:
        return prepare_archive(root, spec)
    except FileNotFoundError:
        return None


def locate_cifar(root: str, name: str, *,
                 allow_download: bool = False) -> Optional[str]:
    """``root`` (e.g. data/cifar10) once it holds ``cifar-10-batches-py/``
    or ``cifar-100-python/``, extracting a placed
    ``cifar-10(0)-python.tar.gz`` there if needed; None when neither is
    there."""
    _refuse_download(allow_download)
    spec = ARCHIVES[name]
    if os.path.isdir(os.path.join(root, spec.foldername)):
        return root
    try:
        prepare_archive(root, spec)
        return root
    except FileNotFoundError:
        return None


def _find_trigger_set(base: str):
    """(pics dir, labels-cifar.txt) under ``base`` at any depth, the
    shallowest and then the first by name where there are several."""
    direct = (os.path.join(base, "pics"),
              os.path.join(base, "labels-cifar.txt"))
    if os.path.isdir(direct[0]) and os.path.exists(direct[1]):
        return direct
    hits = [dirpath for dirpath, dirnames, filenames in os.walk(base)
            if "labels-cifar.txt" in filenames and "pics" in dirnames]
    if hits:
        best = min(hits, key=lambda p: (p.count(os.sep), p))
        return (os.path.join(best, "pics"),
                os.path.join(best, "labels-cifar.txt"))
    return None


def _archive_has_trigger_set(fpath: str) -> bool:
    """Whether the archive lists a labels-cifar.txt at any depth, read
    without extracting; False for an unreadable archive."""
    try:
        if fpath.endswith(".zip"):
            import zipfile

            with zipfile.ZipFile(fpath) as zf:
                names = zf.namelist()
        else:
            mode = "r:gz" if fpath.endswith(".gz") else "r"
            with tarfile.open(fpath, mode) as tar:
                names = tar.getnames()
    except Exception:
        return False
    return any(os.path.basename(n) == "labels-cifar.txt" for n in names)


def locate_trigger_set(base: str = "data/trigger_set", *,
                       allow_download: bool = False):
    """(pics dir, labels path) of the WatermarkNN trigger set, or None:
    found under ``base`` (reference dataset.py:168-174) at any depth, else
    extracted into ``base`` from a placed archive in ``base`` or its parent
    (trigger_set.tar.gz / .zip, or a WatermarkNN repository tarball, of
    which only data/trigger_set/ is extracted). An archive named like one
    that lists no trigger set is passed over with a warning."""
    _refuse_download(allow_download)
    if os.path.isdir(base):
        found = _find_trigger_set(base)
        if found:
            return found
    candidates = []
    for d in (base, os.path.dirname(base) or "."):
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if fn in _WM_ARCHIVE_NAMES or (
                        fn.startswith("WatermarkNN")
                        and fn.endswith((".tar.gz", ".tar", ".zip"))):
                    candidates.append(os.path.join(d, fn))
    for fpath in candidates:
        if not _archive_has_trigger_set(fpath):
            warnings.warn(
                f"{fpath} looks like a trigger-set archive by name but "
                "contains no pics/ + labels-cifar.txt; ignoring it")
            continue
        os.makedirs(base, exist_ok=True)
        extract_archive(fpath, base, only_under="/data/trigger_set/")
        found = _find_trigger_set(base)
        if found:
            return found
    return None
