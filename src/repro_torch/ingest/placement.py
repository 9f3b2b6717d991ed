"""Device-place stage of the ingest pipeline — ``CohortPlacer`` and
``put_global`` of repro/ingest/placement.py.

The cohort round consumes a (K, M, ...) batch stack, a (K, M) mask and
(K,) client ids on the trainer's device. ``CohortPlacer.place`` moves a
staging slot's host tensors there:

  * on the card, the copies are ``non_blocking`` from the slot's PINNED
    buffers on the placer's side ``torch.cuda.Stream``, and a CUDA event
    is recorded after them. ``place`` does not wait for the copies: the
    round's stream waits on the event (``StagedCohort.wait``) before it
    reads the batches, and the ring waits on it before it refills the
    slot's pinned buffers (``CohortPlacer.settle``). Run on the staging
    ring's producer thread (``device_stage=True``), the copy overlaps the
    current round's compute.
  * ``blocking=True`` waits for the event on the calling thread: the
    consumer-thread placement of ``device_stage=False``, whose wait is
    the measured ``RoundRecord.ingest_device_seconds``.
  * on the CPU the placed tensors ARE the slot's tensors (no copy), as
    the reference's CPU ``device_put`` may alias the host buffer: the
    pipeline never refills a slot before its round has released it.

In a multi-process job each rank places only its own rows of the padded
cohort (``local_rows``): the reference's placer assembles a global array
from the hosts' shards, while in the port no tensor spans the ranks — a
rank holds its rows, and the round's collectives combine what the rows
give (core/round.py).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_leaves, tree_map


def put_global(x, device, local_rows: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """The port's counterpart of the reference's ``put_global``: a host
    array onto this rank's device. A replicated value (``local_rows``
    None) lands whole on every rank; a cohort array lands as this rank's
    rows ``x[lo:hi]``. No tensor spanning the ranks exists in the port,
    so there is nothing to assemble."""
    a = np.asarray(x)
    if local_rows is not None:
        a = a[local_rows[0]:local_rows[1]]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class CohortPlacer:
    """Places (batches, masks, ids) on ``device``; see the module
    docstring for the streams and events on the card. ``local_rows``
    (lo, hi) is a rank's slice of a multi-process cohort: what it is
    handed must hold exactly hi - lo rows."""

    def __init__(self, device: torch.device,
                 local_rows: Optional[Tuple[int, int]] = None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the staging thread sets the device by index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.local_rows = local_rows
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def bind_thread(self):
        """Make the trainer's card the calling thread's device (the
        staging thread's pinned allocations and copies go there)."""
        if self.on_card:
            torch.cuda.set_device(self.device)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def place(self, batches, masks: Optional[torch.Tensor],
              ids: Optional[torch.Tensor], blocking: bool = False
              ) -> Tuple[Any, Any, Any, Optional[torch.cuda.Event]]:
        """Host tensors -> (batches, masks, ids, event) on the device; the
        event (None off the card) marks the end of the copies."""
        if self.local_rows is not None:
            want = self.local_rows[1] - self.local_rows[0]
            got = tree_leaves(batches)[0].shape[0]
            if got != want:
                raise ValueError(f"placer of rows {self.local_rows} was "
                                 f"handed {got} rows")
        if not self.on_card:
            return batches, masks, ids, None
        self.bind_thread()
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            def put(x):
                return x.to(self.device, non_blocking=True)
            out = (tree_map(put, batches),
                   None if masks is None else put(masks),
                   None if ids is None else put(ids))
            event = torch.cuda.Event()
            event.record(stream)
        if blocking:
            event.synchronize()
        return (*out, event)

    @staticmethod
    def settle(event: Optional[torch.cuda.Event]):
        """Wait on the host until a placement's copies have read their
        pinned buffers (before the slot holding them is refilled)."""
        if event is not None:
            event.synchronize()

    @staticmethod
    def hand_over(tree, event: Optional[torch.cuda.Event]):
        """Make the current stream wait for a placement and tell the
        allocator the placed tensors are used there: their memory,
        allocated on the side stream, is not reused before the current
        stream is done with them."""
        if event is None:
            return
        stream = torch.cuda.current_stream()
        stream.wait_event(event)
        for t in tree_leaves(tree):
            t.record_stream(stream)
