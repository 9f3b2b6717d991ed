"""Blocking cohort staging — the part of repro/ingest/pipeline.py the
port's rounds use: sample, read, stack, then place on the device, all on
the caller's thread (the reference's prefetch ring is not ported yet).

``stage_blocking(t)`` returns a ``StagedCohort`` with the surface the
round and the buffered-async engine read: ``clients``, ``batches``,
``masks``, ``ids``, ``host_seconds``, ``device_seconds`` and
``release()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.ingest.sources import DataSource
from repro_torch.ingest.stack import stack_cohort


def to_device(tree, device: torch.device):
    """Host numpy tree -> tensors on ``device``; to the card through
    pinned memory with a non-blocking copy."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return bridge.tree_map(put, tree)


@dataclass
class StagedCohort:
    """One round's (or wave's) staged inputs on the device, and the time
    the caller spent staging them: ``host_seconds`` for sample + read +
    stack, ``device_seconds`` for issuing the copies to the device."""
    round: int
    clients: np.ndarray
    batches: Any
    masks: Any
    ids: torch.Tensor
    host_seconds: float = 0.0
    device_seconds: float = 0.0

    def release(self):
        """Blocking staging holds no ring slot: nothing to return."""


class CohortStager:
    """Stages cohorts for the rounds. ``sample_fn(t) -> (K,) client ids``
    is called once per round (or wave), in order; the stager owns the
    grow-once M shape bucket (``max_batches``): M is padded to the
    cohort max and only grows, as in the reference."""

    def __init__(self, source: DataSource,
                 sample_fn: Callable[[int], np.ndarray],
                 device: torch.device):
        self.source = source
        self.sample_fn = sample_fn
        self.device = device
        self.max_batches: Optional[int] = None

    def client_lists(self, clients: Sequence[int], t: int):
        """Read each client's batches for round t and grow the M bucket
        to the cohort max."""
        per_client = [list(self.source.client_batches(int(c), t))
                      for c in clients]
        mx = max(len(b) for b in per_client)
        if self.max_batches is None or mx > self.max_batches:
            self.max_batches = mx
        return per_client

    def stage_blocking(self, t: int) -> StagedCohort:
        tic = time.perf_counter()
        clients = self.sample_fn(t)
        batches, masks = stack_cohort(self.client_lists(clients, t),
                                      self.max_batches)
        host_s = time.perf_counter() - tic
        tic = time.perf_counter()
        batches, masks = to_device((batches, masks), self.device)
        ids = torch.as_tensor(clients, dtype=torch.int32, device=self.device)
        return StagedCohort(t, clients, batches, masks, ids, host_s,
                            time.perf_counter() - tic)
