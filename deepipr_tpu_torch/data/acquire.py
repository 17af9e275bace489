"""Dataset archives: location, hardened extraction, and gated download.

Counterpart of ``deepipr_tpu/data/acquire.py``, kept as a copy (the port
imports nothing of the JAX package). The reference's Caltech classes
(dataset.py:14-139) download ``101_ObjectCategories.tar.gz`` /
``256_ObjectCategories.tar`` into ``root`` and untar them there before
indexing ``root/<foldername>/<class>/<img>``; the port takes such an
archive, or the extracted tree, from where it was placed:

    data/caltech-101/101_ObjectCategories.tar.gz   -> extracted in place
    data/caltech-101/101_ObjectCategories/...      -> used directly

The same holds for the CIFAR archives and the WatermarkNN trigger set.
The network leg is opt-in: with ``allow_download=True`` (``--download``) a
missing archive is fetched from its published URL (``download_url``, with
the reference's https -> http retry), then extracted through the same
checks. Extraction refuses absolute paths, ``..`` components, links that
escape the destination and device members.
"""

from __future__ import annotations

import os
import tarfile
import warnings
from dataclasses import dataclass
from typing import Optional

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


def download_url(url: str, fpath: str) -> None:
    """Fetch ``url`` to ``fpath``, retrying an https URL over http as the
    reference does (dataset.py:107-130). Called only under
    ``allow_download=True``."""
    from urllib import request

    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    try:
        print(f"Downloading {url} to {fpath}")
        request.urlretrieve(url, fpath)
    except OSError:  # URLError and HTTPError among them
        if not url.startswith("https:"):
            raise
        alt = url.replace("https:", "http:", 1)
        print(f"Failed download. Trying https -> http instead. "
              f"Downloading {alt} to {fpath}")
        request.urlretrieve(alt, fpath)


def prepare_archive(root: str, name_or_spec, *,
                    allow_download: bool = False) -> str:
    """``root/<foldername>``, extracted from ``root/<filename>`` if it is
    not there yet (reference dataset.py:89-105), the archive fetched first
    under ``allow_download``; FileNotFoundError with placement instructions
    when neither is there and nothing may be fetched. ``name_or_spec``: an
    ``ARCHIVES`` key or an ``ArchiveSpec``."""
    spec = (ARCHIVES[name_or_spec] if isinstance(name_or_spec, str)
            else name_or_spec)
    folder = os.path.join(root, spec.foldername)
    if os.path.isdir(folder):
        return folder
    fpath = os.path.join(root, spec.filename)
    if not os.path.exists(fpath):
        if not allow_download:
            raise FileNotFoundError(
                f"{folder} not found and {spec.filename} is not present in "
                f"{root}. Place the archive there (or the extracted "
                f"{spec.foldername}/ tree), or pass --download / "
                f"allow_download=True to fetch {spec.url}.")
        download_url(spec.url, fpath)
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
    None when neither is there and nothing may be fetched."""
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
        return prepare_archive(root, spec, allow_download=allow_download)
    except FileNotFoundError:
        if allow_download:
            raise
        return None


def locate_cifar(root: str, name: str, *,
                 allow_download: bool = False) -> Optional[str]:
    """``root`` (e.g. data/cifar10) once it holds ``cifar-10-batches-py/``
    or ``cifar-100-python/``, extracting a placed
    ``cifar-10(0)-python.tar.gz`` there if needed, fetched from
    torchvision's URL under ``allow_download`` (reference
    dataset.py:262-267); None when neither is there and nothing may be
    fetched."""
    spec = ARCHIVES[name]
    if os.path.isdir(os.path.join(root, spec.foldername)):
        return root
    try:
        prepare_archive(root, spec, allow_download=allow_download)
        return root
    except FileNotFoundError:
        if allow_download:
            raise
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
    which only data/trigger_set/ is extracted), else under
    ``allow_download`` the WatermarkNN repository tarball fetched from
    GitHub. An archive named like one that lists no trigger set is passed
    over with a warning."""
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
    if allow_download:
        os.makedirs(base, exist_ok=True)
        fpath = os.path.join(base, WATERMARKNN.filename)
        download_url(WATERMARKNN.url, fpath)
        extract_archive(fpath, base, only_under="/data/trigger_set/")
        return _find_trigger_set(base)
    return None
