"""Device-place stage of the ingest pipeline — the single-process part of
repro/ingest/placement.py's ``CohortPlacer``.

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

``put_global`` and the multi-process assembly of the reference wait for
multi-device execution (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.bridge import tree_leaves, tree_map


class CohortPlacer:
    """Places (batches, masks, ids) on ``device``; see the module
    docstring for the streams and events on the card."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the staging thread sets the device by index
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
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
