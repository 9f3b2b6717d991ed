"""[Copy of repro/ingest/datasets.py — numpy only, verbatim apart from imports.]

Disk-backed federated DataSource impls + the decode/augment stage
(DESIGN.md §10): the paper's real datasets behind the §3 protocol.

``CIFAR10Source`` / ``CIFAR100Source`` / ``TinyImageNetSource`` wrap the
format readers (ingest/readers.py), Dirichlet-partition the training
labels across clients (data/dirichlet.py — the paper's heterogeneity
model), and stream round-seeded per-client batches through
``client_batches``. Records stay uint8 until a batch is drawn: the
DECODE stage (uint8 -> [-1, 1] float32) and the optional AUGMENT stage
(reflect-pad random crop + horizontal flip) run lazily on the ingest
path — the staging ring's producer thread when prefetching is on — so a
4x smaller uint8 working set lives in host memory and per-batch decode
work overlaps device compute.

Determinism contract (same as ingest/images.client_batches): everything
a round yields for a client is a pure function of (client, round, the
source's construction arguments) — batch order, wrap-padding, and the
augmentation draws all come from ``RandomState(hash((client, round)))``
— so prefetched, blocking, serial, and resumed runs see identical bytes.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.ingest import readers
from repro_torch.ingest.images import iter_batch_selections
from repro_torch.ingest.sources import DataSource


def decode_images(raw: np.ndarray) -> np.ndarray:
    """DECODE stage: uint8 pixels -> float32 in [-1, 1] (the range the
    synthetic pipeline and the vision models already use)."""
    return (np.asarray(raw, np.float32) / 127.5) - 1.0


def augment_images(imgs: np.ndarray, rng: np.random.RandomState,
                   pad: int = 4, flip: bool = True) -> np.ndarray:
    """AUGMENT stage: per-image reflect-pad random crop + horizontal
    flip (the standard CIFAR recipe). Deterministic given ``rng``."""
    n, h, w = imgs.shape[:3]
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    flips = rng.rand(n) < 0.5 if flip else np.zeros(n, bool)
    out = np.empty_like(imgs)
    for i in range(n):
        crop = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


class DiskImageSource(DataSource):
    """Dirichlet-partitioned disk-backed image source.

    ``labels`` (N,) drive the partition; ``fetch(indices) -> (B, H, W,
    3) uint8`` is the read stage (an in-memory slice for CIFAR, lazy
    file decode for TinyImageNet). Subclasses are thin constructors.
    """

    def __init__(self, labels: np.ndarray,
                 fetch: Callable[[np.ndarray], np.ndarray], *,
                 num_clients: int, alpha: float, batch_size: int,
                 local_epochs: int = 1, augment: bool = False,
                 seed: int = 0, min_size: int = 2):
        self.labels = np.asarray(labels, np.int32)
        self.fetch = fetch
        self.num_clients = num_clients
        self.batch_size = batch_size
        self.local_epochs = local_epochs
        self.augment = augment
        self.client_indices: List[np.ndarray] = dirichlet_partition(
            self.labels, num_clients, alpha, seed=seed, min_size=min_size)

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    def client_weights(self) -> np.ndarray:
        return np.asarray([len(ix) for ix in self.client_indices],
                          np.float64)

    def client_batches(self, client: int, round: int
                       ) -> Iterator[dict]:
        # index iteration shared with the array-backed pipeline
        # (ingest/images.iter_batch_selections) — one source of truth
        # for the (client, round) determinism contract; augmentation
        # draws from the same per-round rng between batches
        for sel, rng in iter_batch_selections(
                self.client_indices[client], self.batch_size, client,
                round, self.local_epochs):
            imgs = decode_images(self.fetch(sel))
            if self.augment:
                imgs = augment_images(imgs, rng)
            yield {"images": imgs,
                   "labels": self.labels[sel].astype(np.int32)}


class _ArraySource(DiskImageSource):
    """Shared CIFAR constructor body: eager uint8 arrays + test split."""

    def __init__(self, data: readers.ArrayImageData, *, num_clients: int,
                 alpha: float, batch_size: int, **kw):
        self._data = data
        super().__init__(data.train_labels,
                         lambda sel: data.train_images[sel],
                         num_clients=num_clients, alpha=alpha,
                         batch_size=batch_size, **kw)

    def test_arrays(self):
        """(images float32 [-1,1], labels int32) — the held-out split,
        decoded once, for eval_fn construction."""
        return (decode_images(self._data.test_images),
                self._data.test_labels.astype(np.int32))


class CIFAR10Source(_ArraySource):
    """FedDPC §5.1's CIFAR-10: Dirichlet(alpha)-partitioned, disk-backed
    (the standard cifar-10-batches-py download under ``root``)."""

    def __init__(self, root: str, *, num_clients: int = 100,
                 alpha: float = 0.2, batch_size: int = 64, **kw):
        super().__init__(readers.load_cifar10(root),
                         num_clients=num_clients, alpha=alpha,
                         batch_size=batch_size, **kw)


class CIFAR100Source(_ArraySource):
    """CIFAR-100 with fine labels (cifar-100-python under ``root``)."""

    def __init__(self, root: str, *, num_clients: int = 100,
                 alpha: float = 0.2, batch_size: int = 64, **kw):
        super().__init__(readers.load_cifar100(root),
                         num_clients=num_clients, alpha=alpha,
                         batch_size=batch_size, **kw)


class TinyImageNetSource(DiskImageSource):
    """TinyImageNet (tiny-imagenet-200 under ``root``): path-indexed,
    images read + decoded lazily per batch on the ingest path, so the
    1.2 GB training set never materializes in host memory at once."""

    def __init__(self, root: str, *, num_clients: int = 100,
                 alpha: float = 0.2, batch_size: int = 64,
                 image_size: Optional[int] = 64,
                 decode_workers: int = 0, **kw):
        self.index = readers.load_tiny_imagenet(root)
        self.image_size = image_size
        # bounded read/decode pool (ExecConfig.decode_workers); 0 =
        # serial. Output order is pinned to the selection order either
        # way, so the batch stacks are bit-identical across settings.
        self.decoder = readers.ImageDecodePool(decode_workers)
        paths = self.index.train_paths

        def fetch(sel):
            return np.stack(self.decoder.decode(
                [paths[i] for i in sel], image_size))

        super().__init__(self.index.train_labels, fetch,
                         num_clients=num_clients, alpha=alpha,
                         batch_size=batch_size, **kw)

    @property
    def num_classes(self) -> int:
        return self.index.num_classes

    def test_arrays(self):
        """Decoded val split (eagerly — it is 20x smaller than train)."""
        imgs = np.stack(self.decoder.decode(self.index.val_paths,
                                            self.image_size))
        return decode_images(imgs), self.index.val_labels.astype(np.int32)
