"""[Copy of repro/ingest/images.py — numpy only, verbatim apart from imports.]

Array-backed federated image pipeline: per-client datasets + seeded
batch iteration (moved here from the retired
data/pipeline.py — DESIGN.md §10).

Mirrors the paper's setup: each client holds a Dirichlet-skewed shard;
every local epoch shuffles with a round-dependent seed; batches are padded
by wrap-around so a client with fewer samples than the batch size still
yields one full batch (matches FedAvg-style implementations).

``StreamingImageSource`` is the DataSource (ingest/sources.py) view of
this pipeline: it hands the trainer the ``client_batches`` GENERATOR, so
the gather/slice work materializes lazily on the ingest path — inside the
staging ring's producer thread when prefetching is on, overlapping data
IO with the device round instead of requiring pre-built per-client lists.
The DISK-backed equivalents (CIFAR/TinyImageNet readers) live in
ingest/datasets.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.ingest.sources import DataSource


@dataclass
class FederatedImageData:
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    client_indices: List[np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)


def build_federated_image_data(num_classes=10, num_clients=100, alpha=0.2,
                               samples_per_class=500, test_per_class=100,
                               image_size=32, seed=0,
                               noise=0.35) -> FederatedImageData:
    tr_x, tr_y = make_image_dataset(num_classes, samples_per_class,
                                    image_size=image_size, seed=seed,
                                    noise=noise)
    te_x, te_y = make_image_dataset(num_classes, test_per_class,
                                    image_size=image_size, seed=seed + 10_000,
                                    noise=noise)
    parts = dirichlet_partition(tr_y, num_clients, alpha, seed=seed)
    return FederatedImageData(tr_x, tr_y, te_x, te_y, parts)


def iter_batch_selections(idx: np.ndarray, batch_size: int, client: int,
                          round_num: int, local_epochs: int = 1):
    """The determinism-critical index iteration EVERY image source shares
    (this module's array-backed pipeline and the disk-backed sources in
    ingest/datasets.py): yields ``(sel, rng)`` per batch, where ``sel``
    indexes ``batch_size`` samples of the client's shard and ``rng`` is
    the round's ``RandomState(hash((client, round)))`` — shuffled per
    local epoch, tiny shards wrap-padded to one full batch, the
    remainder dropped. One source of truth for the "pure function of
    (client, round)" contract; callers may draw from ``rng`` between
    batches (augmentation) without breaking it."""
    rng = np.random.RandomState(hash((client, round_num)) % (2 ** 31))
    for _ in range(local_epochs):
        order = rng.permutation(len(idx))
        n = len(order)
        if n < batch_size:          # wrap-pad tiny clients to one full batch
            order = np.resize(order, batch_size)
            n = batch_size
        for start in range(0, n - batch_size + 1, batch_size):
            yield idx[order[start:start + batch_size]], rng


def client_batches(data: FederatedImageData, client: int, batch_size: int,
                   round_num: int, local_epochs: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches for `local_epochs` epochs over the client's shard."""
    for sel, _ in iter_batch_selections(data.client_indices[client],
                                        batch_size, client, round_num,
                                        local_epochs):
        yield {"images": data.train_images[sel],
               "labels": data.train_labels[sel]}


class StreamingImageSource(DataSource):
    """Streams ``client_batches`` straight into the trainer's ingest path
    (ingest/sources.DataSource protocol): batches materialize as the
    cohort stacker consumes the generator — with prefetch on, on the
    staging thread, so shard gathering overlaps device compute.

    ``client_weights()`` exposes shard sizes for ``WeightedSampler``
    (participation proportional to data size)."""

    def __init__(self, data: FederatedImageData, batch_size: int,
                 local_epochs: int = 1):
        self.data = data
        self.batch_size = batch_size
        self.local_epochs = local_epochs

    def client_batches(self, client: int, round: int):
        return client_batches(self.data, client, self.batch_size, round,
                              self.local_epochs)

    def client_weights(self) -> np.ndarray:
        return np.asarray([len(ix) for ix in self.data.client_indices],
                          np.float64)
