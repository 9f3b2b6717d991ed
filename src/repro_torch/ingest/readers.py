"""[Copy of repro/ingest/readers.py — numpy only, verbatim.]

On-disk dataset readers — the READ stage behind the disk-backed
DataSource impls (ingest/datasets.py; DESIGN.md §10).

Readers understand the datasets' STANDARD distribution formats, so a
directory produced by the official downloads works as-is, with no
network access at runtime:

  CIFAR-10    <root>/cifar-10-batches-py/{data_batch_*, test_batch}
              python pickles: {b"data": uint8 (N, 3072) row-major RGB
              planes, b"labels": [int]}
  CIFAR-100   <root>/cifar-100-python/{train, test}
              python pickles: {b"data": uint8 (N, 3072),
              b"fine_labels": [int]}
  TinyImageNet <root>/tiny-imagenet-200/
              wnids.txt; train/<wnid>/images/<img>.JPEG;
              val/images/<img>.JPEG + val/val_annotations.txt

CIFAR loads into memory as uint8 (the pickle format is not seekable;
~180 MB for the full set — decode to float happens per batch on the
ingest path, see ingest/datasets.py). TinyImageNet is indexed by PATH
and images are read+decoded lazily per batch — the full set does not
need to fit in host memory. Image files decode via PIL when present
(the standard JPEGs) and via ``np.load`` for ``.npy`` files — the
dependency-free format the committed test fixtures use; a JPEG tree
without PIL fails with an actionable error instead of an import crash.

``write_*_fixture`` emit tiny synthetic datasets in the EXACT on-disk
formats above: the committed CI fixtures (tests/fixtures/) are generated
with them, and they double as executable format documentation.
"""
from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpeg", ".jpg", ".png", ".bmp", ".npy")


def _resolve(root: str, inner: str) -> str:
    """Accept either the dataset directory itself or its parent."""
    cand = os.path.join(root, inner)
    if os.path.isdir(cand):
        return cand
    if os.path.isdir(root):
        return root
    raise FileNotFoundError(
        f"no dataset at {root!r} (expected it to be, or to contain, "
        f"{inner!r})")


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _rows_to_images(rows: np.ndarray) -> np.ndarray:
    """CIFAR's (N, 3072) row-major RGB planes -> (N, 32, 32, 3) uint8."""
    n = rows.shape[0]
    return rows.reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)


@dataclass
class ArrayImageData:
    """An in-memory uint8 image dataset (CIFAR-shaped)."""
    train_images: np.ndarray    # (N, H, W, 3) uint8
    train_labels: np.ndarray    # (N,) int32
    test_images: np.ndarray
    test_labels: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(self.train_labels.max()) + 1


def _load_cifar_files(paths: List[str], label_key: bytes
                      ) -> Tuple[np.ndarray, np.ndarray]:
    imgs, labels = [], []
    for p in paths:
        d = _unpickle(p)
        imgs.append(_rows_to_images(np.asarray(d[b"data"], np.uint8)))
        labels.append(np.asarray(d[label_key], np.int32))
    return np.concatenate(imgs), np.concatenate(labels)


def load_cifar10(root: str) -> ArrayImageData:
    d = _resolve(root, "cifar-10-batches-py")
    train = sorted(glob.glob(os.path.join(d, "data_batch_*")))
    test = os.path.join(d, "test_batch")
    if not train or not os.path.exists(test):
        raise FileNotFoundError(
            f"{d} does not look like cifar-10-batches-py (need "
            "data_batch_* and test_batch)")
    tr = _load_cifar_files(train, b"labels")
    te = _load_cifar_files([test], b"labels")
    return ArrayImageData(*tr, *te)


def load_cifar100(root: str) -> ArrayImageData:
    d = _resolve(root, "cifar-100-python")
    train, test = os.path.join(d, "train"), os.path.join(d, "test")
    if not (os.path.exists(train) and os.path.exists(test)):
        raise FileNotFoundError(
            f"{d} does not look like cifar-100-python (need train + test)")
    tr = _load_cifar_files([train], b"fine_labels")
    te = _load_cifar_files([test], b"fine_labels")
    return ArrayImageData(*tr, *te)


# ---------------- TinyImageNet (path-indexed, lazy decode) ----------------

@dataclass
class ImageFileIndex:
    """A disk-backed image dataset indexed by path; pixels are read and
    decoded lazily, per batch, on the ingest path."""
    train_paths: List[str]
    train_labels: np.ndarray    # (N,) int32 indices into wnids
    val_paths: List[str]
    val_labels: np.ndarray
    wnids: List[str]

    @property
    def num_classes(self) -> int:
        return len(self.wnids)


def _list_images(d: str) -> List[str]:
    out = [p for p in sorted(glob.glob(os.path.join(d, "*")))
           if p.lower().endswith(IMG_EXTENSIONS)]
    return out


def load_tiny_imagenet(root: str) -> ImageFileIndex:
    d = _resolve(root, "tiny-imagenet-200")
    wnids_file = os.path.join(d, "wnids.txt")
    if not os.path.exists(wnids_file):
        raise FileNotFoundError(f"{d} has no wnids.txt — not a "
                                "tiny-imagenet-200 layout")
    with open(wnids_file) as f:
        wnids = [line.strip() for line in f if line.strip()]
    wnid_idx = {w: i for i, w in enumerate(wnids)}
    train_paths, train_labels = [], []
    for w in wnids:
        imgs = _list_images(os.path.join(d, "train", w, "images"))
        if not imgs:
            raise FileNotFoundError(f"no images under train/{w}/images")
        train_paths.extend(imgs)
        train_labels.extend([wnid_idx[w]] * len(imgs))
    val_paths, val_labels = [], []
    ann = os.path.join(d, "val", "val_annotations.txt")
    if os.path.exists(ann):
        by_name = {}
        with open(ann) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[1] in wnid_idx:
                    by_name[parts[0]] = wnid_idx[parts[1]]
        for p in _list_images(os.path.join(d, "val", "images")):
            name = os.path.basename(p)
            if name in by_name:
                val_paths.append(p)
                val_labels.append(by_name[name])
    return ImageFileIndex(train_paths,
                          np.asarray(train_labels, np.int32),
                          val_paths, np.asarray(val_labels, np.int32),
                          wnids)


def decode_image_file(path: str, image_size: Optional[int] = None
                      ) -> np.ndarray:
    """One image file -> (H, W, 3) uint8. ``.npy`` decodes with numpy
    alone (the fixture format); JPEG/PNG/BMP need PIL and fail with an
    actionable message when it is absent (this container-friendly gating
    is why the committed fixtures are .npy)."""
    if path.lower().endswith(".npy"):
        img = np.load(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:        # pragma: no cover - env dependent
            raise RuntimeError(
                f"decoding {path} needs PIL (pip install pillow), which "
                "is not available here; re-encode the dataset as .npy "
                "files (ingest.readers accepts them in the same layout)"
            ) from e
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:                   # grayscale -> 3 channels
        img = np.repeat(img[..., None], 3, axis=-1)
    if image_size is not None and img.shape[:2] != (image_size, image_size):
        raise ValueError(f"{path}: expected {image_size}x{image_size}, "
                         f"got {img.shape[:2]}")
    return img


class ImageDecodePool:
    """Bounded thread pool for the per-image file decode of path-indexed
    sources (TinyImageNet). The read+decode of a batch's images is
    embarrassingly parallel and GIL-friendly (PIL decode and np.load
    release the GIL around I/O), so a few workers hide disk latency on
    the ingest path without touching memory behavior — images still
    materialize one batch at a time.

    ``workers <= 1`` decodes serially on the caller's thread (the
    default — ExecConfig.decode_workers=0). OUTPUT ORDER IS THE INPUT
    ORDER regardless of completion order (Executor.map semantics), so
    the batch stack is bit-identical to the serial decode and the
    (client, round) determinism contract of ingest/images.py holds.

    The pool is created lazily on first parallel decode, so constructing
    a source with workers configured costs nothing until data flows;
    ``close()`` joins the workers (idempotent; also safe to never call —
    executor threads exit with the interpreter).
    """

    def __init__(self, workers: int = 0):
        self.workers = max(0, int(workers))
        self._pool = None

    def _ensure(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="repro-img-decode")
        return self._pool

    def decode(self, paths: List[str], image_size: Optional[int] = None
               ) -> List[np.ndarray]:
        if self.workers <= 1 or len(paths) <= 1:
            return [decode_image_file(p, image_size) for p in paths]
        return list(self._ensure().map(
            lambda p: decode_image_file(p, image_size), paths))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


# ---------------- fixture writers (format round-trip) ----------------

def _fixture_images(rng: np.random.RandomState, labels: np.ndarray,
                    size: int) -> np.ndarray:
    """Class-conditional uint8 blobs: the per-image mean is pinned to
    ~(label % 10) * 23 + 25, so reader tests can verify the
    label<->pixel association survives the format round-trip (catches
    e.g. transposed CIFAR planes)."""
    n = len(labels)
    base = (labels[:, None, None, None].astype(np.float32) % 10) * 23.0 + 5.0
    noise = rng.randint(0, 40, size=(n, size, size, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def write_cifar10_fixture(root: str, *, per_class: int = 4,
                          test_per_class: int = 2, train_batches: int = 2,
                          seed: int = 0) -> str:
    """Emit a tiny cifar-10-batches-py tree under ``root`` (all 10
    classes, ``per_class`` train images each, split over
    ``train_batches`` data_batch_* files)."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)

    def dump(path, labels):
        imgs = _fixture_images(rng, labels, 32)
        rows = imgs.transpose(0, 3, 1, 2).reshape(len(labels), 3072)
        with open(path, "wb") as f:
            pickle.dump({b"data": rows,
                         b"labels": [int(y) for y in labels]}, f)

    train_y = np.repeat(np.arange(10), per_class)
    rng.shuffle(train_y)
    for i, part in enumerate(np.array_split(train_y, train_batches)):
        dump(os.path.join(d, f"data_batch_{i + 1}"), part)
    test_y = np.repeat(np.arange(10), test_per_class)
    dump(os.path.join(d, "test_batch"), test_y)
    return d


def write_cifar100_fixture(root: str, *, num_classes: int = 100,
                           per_class: int = 1, test_per_class: int = 1,
                           seed: int = 0) -> str:
    """Emit a tiny cifar-100-python tree under ``root`` (fine labels
    0..num_classes-1; the real set has 100)."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)

    def dump(path, labels):
        imgs = _fixture_images(rng, labels, 32)
        rows = imgs.transpose(0, 3, 1, 2).reshape(len(labels), 3072)
        with open(path, "wb") as f:
            pickle.dump({b"data": rows,
                         b"fine_labels": [int(y) for y in labels]}, f)

    dump(os.path.join(d, "train"), np.repeat(np.arange(num_classes),
                                             per_class))
    dump(os.path.join(d, "test"), np.repeat(np.arange(num_classes),
                                            test_per_class))
    return d


def write_tiny_imagenet_fixture(root: str, *, num_wnids: int = 4,
                                per_wnid: int = 4, val_per_wnid: int = 1,
                                image_size: int = 64, seed: int = 0) -> str:
    """Emit a tiny tiny-imagenet-200 tree under ``root``. Images are
    written as ``.npy`` (decodable without PIL — the committed-fixture
    format); the directory layout matches the real download exactly."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "tiny-imagenet-200")
    wnids = [f"n{90000000 + i:08d}" for i in range(num_wnids)]
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "wnids.txt"), "w") as f:
        f.write("\n".join(wnids) + "\n")
    for ci, w in enumerate(wnids):
        img_dir = os.path.join(d, "train", w, "images")
        os.makedirs(img_dir, exist_ok=True)
        labels = np.full(per_wnid, ci, np.int64)
        imgs = _fixture_images(rng, labels, image_size)
        for i in range(per_wnid):
            np.save(os.path.join(img_dir, f"{w}_{i}.npy"), imgs[i])
    val_dir = os.path.join(d, "val", "images")
    os.makedirs(val_dir, exist_ok=True)
    lines = []
    for ci, w in enumerate(wnids):
        labels = np.full(val_per_wnid, ci, np.int64)
        imgs = _fixture_images(rng, labels, image_size)
        for i in range(val_per_wnid):
            name = f"val_{w}_{i}.npy"
            np.save(os.path.join(val_dir, name), imgs[i])
            lines.append(f"{name}\t{w}\t0\t0\t{image_size}\t{image_size}")
    with open(os.path.join(d, "val", "val_annotations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return d
