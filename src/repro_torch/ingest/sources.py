"""[Copy of repro/ingest/sources.py — numpy only, verbatim apart from imports.]

Pluggable client data sources — the READ stage of the ingest pipeline
(DESIGN.md §10; moved here from the retired core/datasources.py).

``DataSource`` replaces the bare ``batch_fn(client, round) -> list``
callable the trainer historically took: a source yields one client's
minibatches for one round, and the pipeline materializes them ON THE
INGEST PATH — with prefetching on, that is the staging ring's producer
thread, so a source backed by disk/host IO overlaps device compute for
free instead of forcing callers to pre-materialize lists.

Protocol:

    source.client_batches(client, round) -> iterable of batch pytrees
        (numpy leaves; every batch of a client/round has the same
        shapes, and shapes are shared across clients so cohorts stack)
    source.close()    release any underlying readers (optional)

Sources are CALLER-owned: sweeps share one source across many trainers
(benchmarks/common.py), so ``FederatedTrainer.close()`` never calls
``source.close()`` — close it yourself when the last trainer is done.

``ListDataSource`` adapts the legacy callable signature verbatim.
``IteratorDataSource`` wraps any ``iter_fn(client, round)`` generator
factory; sources with their own state (ingest.images.
StreamingImageSource, the disk-backed readers in ingest.datasets)
subclass ``DataSource`` directly instead.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List

Batch = Any


class DataSource:
    """Protocol + base class: subclass and implement ``client_batches``."""

    def client_batches(self, client: int, round: int) -> Iterable[Batch]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ListDataSource(DataSource):
    """Adapter for the legacy ``batch_fn(client, round) -> list`` shape —
    the old trainer signature spelled as a source."""

    def __init__(self, batch_fn: Callable[[int, int], List[Batch]]):
        self.batch_fn = batch_fn

    def client_batches(self, client, round):
        return self.batch_fn(client, round)


class IteratorDataSource(DataSource):
    """Streaming source: ``iter_fn(client, round)`` returns a fresh
    iterator/generator whose items materialize lazily as the ingest path
    consumes them (inside the staging thread when prefetching is on)."""

    def __init__(self, iter_fn: Callable[[int, int], Iterable[Batch]]):
        self.iter_fn = iter_fn

    def client_batches(self, client, round):
        return self.iter_fn(client, round)


def as_data_source(obj) -> DataSource:
    """Coerce the trainer's ``data`` argument: a ``DataSource`` passes
    through; a bare callable (the legacy ``batch_fn``) is wrapped."""
    if isinstance(obj, DataSource):
        return obj
    if callable(obj):
        return ListDataSource(obj)
    raise TypeError(f"expected a DataSource or a batch_fn callable, "
                    f"got {type(obj).__name__}")
