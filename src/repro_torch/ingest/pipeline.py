"""Staged cohort ingest pipeline — ``CohortIngestPipeline`` and
``StagedCohort`` of repro/ingest/pipeline.py.

One object owns the whole host->device feed path of the cohort round as
four stages:

    read           source.client_batches(client, round)  (ingest/sources)
    decode/augment inside the source's iterable (ingest/datasets)
    cohort-stack   stack_cohort_into a ring slot's preallocated host
                   tensors, pinned on the card (ingest/stack)
    device-place   a non-blocking copy on a side stream (ingest/placement)

With ``depth >= 1`` staging slots and ``CohortPrefetcher`` the stages for
rounds t+1..t+depth run on a producer thread while round t runs on the
card. ``device_stage=True`` runs the device-place stage on the producer
thread too: the round's stream only waits on the copy's event, and the
consumer's wait is the staging wait (RoundRecord.ingest_host_seconds).
``device_stage=False`` places on the consumer thread and waits for the
copy there, measured as RoundRecord.ingest_device_seconds.
``stage_blocking(t)`` (``ExecConfig.prefetch=False``, the serial path's
reads) stages round t inline on the caller's thread.

Client SAMPLING stays inside ``sample_fn`` (the trainer's, which
snapshots pre-draw RNG and sampler state for checkpointing): the pipeline
calls it in round order from whichever thread stages the round, so a
prefetched run draws exactly what a blocking one draws.

In a multi-process job every rank draws the whole cohort alike, and
``local_rows=(lo, hi)`` makes a rank read, stack and place only its rows
of the cohort padded to ``pad_to`` (masked dummy rows past the real
clients). ``sync_max_batches(tag, m)`` (launch/distributed.kv_allmax,
through the job's store: it runs on the producer thread) makes every
rank stage the same minibatch bucket M. The results do not depend on M —
masked steps are no-ops — but equal M keeps the ranks' shapes and
launches alike.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ingest.placement import CohortPlacer
from repro_torch.ingest.prefetch import CohortPrefetcher
from repro_torch.ingest.sources import DataSource
from repro_torch.ingest.stack import stack_cohort_into


@dataclass
class StagedCohort:
    """One round's (or wave's) staged inputs on the device and the
    consumer-side waits that produced them: ``host_seconds`` blocked on
    sample + read + stack (with prefetch on, the wait for the staged
    round), ``device_seconds`` blocked on the copy to the device.
    ``clients`` is the sampled cohort (host).

    ``wait()`` makes the current stream wait for the copy before the
    round reads the batches. ``release()`` returns the staging slot to
    the ring and MUST be called (idempotent; a try/finally around the
    round) only after the round has synchronized on its results."""
    round: int
    clients: np.ndarray
    batches: Any
    masks: Any
    ids: torch.Tensor
    host_seconds: float = 0.0
    device_seconds: float = 0.0
    _event: Any = field(default=None, repr=False)
    _release: Optional[Callable[[], None]] = field(default=None, repr=False)

    def wait(self):
        event, self._event = self._event, None
        CohortPlacer.hand_over((self.batches, self.masks, self.ids), event)

    def release(self):
        if self._release is not None:
            release, self._release = self._release, None
            release()


class CohortIngestPipeline:
    """Stages cohorts for the vectorized round and the async engine's
    waves; also owns the read stage (and the grow-once M shape bucket)
    for the serial path.

    ``sample_fn(t) -> (K,) client ids`` is called exactly once per round,
    in round order. ``rounds=None`` is the async engine's open horizon.
    The producer is supervised: a staging failure is retried up to
    ``max_restarts`` times over the pipeline's life, with exponential
    backoff from ``restart_backoff`` seconds; ``crash_hook(t, attempt)``
    -> bool is the fault-injection seam (core/faults.FaultPlan.
    ingest_crash). Past the budget the run raises; nothing falls back to
    blocking staging."""

    def __init__(self, source: DataSource,
                 sample_fn: Callable[[int], np.ndarray], *,
                 num_clients: int, rounds: Optional[int],
                 placer: CohortPlacer, depth: int = 2,
                 device_stage: bool = True,
                 stall_timeout: Optional[float] = None,
                 max_restarts: int = 0, restart_backoff: float = 0.05,
                 crash_hook: Optional[Callable[[int, int], bool]] = None,
                 pad_to: Optional[int] = None,
                 local_rows: Optional[Tuple[int, int]] = None,
                 sync_max_batches: Optional[Callable[[str, int], int]]
                 = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if local_rows is not None and pad_to is None:
            raise ValueError("local_rows staging needs pad_to (the padded "
                             "cohort size)")
        self.pad_to = pad_to
        self.local_rows = local_rows
        self.sync_max_batches = sync_max_batches
        self._sync_calls: dict = {}     # round -> bucket syncs so far
        self.source = source
        self.sample_fn = sample_fn
        self.num_clients = num_clients
        self.rounds = rounds
        self.depth = depth
        self.device_stage = device_stage
        self.placer = placer
        self.stall_timeout = stall_timeout
        self.max_restarts = max(0, int(max_restarts))
        self.restart_backoff = float(restart_backoff)
        self._crash_hook = crash_hook
        self._attempts: dict = {}       # round -> produce attempts so far
        self._sampled: dict = {}        # round -> drawn cohort (retry cache)
        self._blocking_restarts = 0     # stage_blocking's share of the tally
        self._blocking_rounds: dict = {}  # round -> stage_blocking restarts
        self.max_batches: Optional[int] = None   # the grow-once M bucket
        self._ring: Optional[CohortPrefetcher] = None
        self._blocking_slot: dict = {}   # stage_blocking's private buffer

    # ---- shared read stage / shape bucket ----

    def client_lists(self, clients: Sequence[int], t: int):
        """READ (+decode) stage: materialize each sampled client's
        batches for round t and grow the M bucket to the cohort max."""
        per_client = [list(self.source.client_batches(int(c), t))
                      for c in clients]
        mx = max(len(b) for b in per_client)
        if self.max_batches is None or mx > self.max_batches:
            self.max_batches = mx
        return per_client

    # ---- staging ----

    def _stage_host(self, t: int, slot: dict):
        """sample -> read -> stack into the slot's buffers. The drawn
        cohort is cached per round until staging succeeds: a supervised
        retry must not call ``sample_fn`` again (a re-draw would shift
        every later round's schedule)."""
        if t in self._sampled:
            clients = self._sampled[t]
        else:
            clients = self.sample_fn(t)
            self._sampled[t] = clients
        rows = np.asarray(clients, np.int32)
        pad_to = self.pad_to
        if self.local_rows is not None:
            # the whole cohort was drawn (alike on every rank); read this
            # rank's rows of it
            lo, hi = self.local_rows
            rows = rows[lo:hi]
            if rows.size == 0:
                raise ValueError(
                    f"rank rows [{lo}, {hi}) hold no real client of the "
                    f"{len(clients)}-client cohort — every rank needs at "
                    "least one; use fewer ranks or a larger cohort")
            pad_to = hi - lo
        lists = self.client_lists(rows, t)
        if self.sync_max_batches is not None:
            n = self._sync_calls.get(t, 0)
            self._sync_calls[t] = n + 1
            self.max_batches = int(self.sync_max_batches(
                f"{t}.{n}", int(self.max_batches)))
        self.placer.bind_thread()
        # the slot's last copy must have read its pinned buffers
        CohortPlacer.settle(slot.pop("event", None))
        pin = self.placer.on_card
        batches, masks = stack_cohort_into(lists, self.max_batches, slot,
                                           pad_to=pad_to, pin=pin)
        kp = len(rows) if pad_to is None else max(pad_to, len(rows))
        ids = slot.get("ids")
        if ids is None or ids.shape[0] != kp:
            ids = slot["ids"] = torch.empty(kp, dtype=torch.int32,
                                            pin_memory=pin)
        # dummy rows carry num_clients: out of range, as the reference's
        ids.numpy()[:] = self.num_clients
        ids.numpy()[:len(rows)] = rows
        return clients, batches, masks, ids

    def _place(self, slot: dict, batches, masks, ids, blocking: bool):
        batches, masks, ids, event = self.placer.place(batches, masks, ids,
                                                       blocking)
        slot["event"] = event
        return batches, masks, ids, event

    def _crash_check(self, t: int):
        attempt = self._attempts.get(t, 0)
        self._attempts[t] = attempt + 1
        if self._crash_hook is not None and self._crash_hook(t, attempt):
            raise RuntimeError(f"injected ingest producer crash at round "
                               f"{t} (attempt {attempt})")

    def _produce(self, t: int, slot: dict):
        """Ring-producer body. Device-staged, the copy to the device is
        issued here too. The crash hook fires BEFORE sampling, so an
        injected crash and its restart replay the no-fault RNG stream."""
        self._crash_check(t)
        clients, batches, masks, ids = self._stage_host(t, slot)
        event = None
        if self.device_stage:
            batches, masks, ids, event = self._place(slot, batches, masks,
                                                     ids, blocking=False)
        self._sampled.pop(t, None)
        self._attempts.pop(t, None)
        return clients, batches, masks, ids, event

    def get(self, t: int) -> StagedCohort:
        """Prefetching consumer: blocks only until round t is staged
        (and, host-staged, on its own copy). Rounds must be consumed in
        order from the first ``get``; the caller owns the slot until
        ``StagedCohort.release()``."""
        if self._ring is None:
            self._ring = CohortPrefetcher(
                self._produce, t, self.rounds, slots=self.depth,
                stall_timeout=self.stall_timeout,
                max_restarts=self.max_restarts,
                restart_backoff=self.restart_backoff)
            # a pipeline dropped without close() ends its producer
            weakref.finalize(self, self._ring.signal_stop)
        tic = time.perf_counter()
        (clients, batches, masks, ids, event), slot = self._ring.get(t)
        host_s = time.perf_counter() - tic
        dev_s = 0.0
        ring = self._ring
        if not self.device_stage:
            try:
                tic = time.perf_counter()
                batches, masks, ids, event = self._place(
                    slot, batches, masks, ids, blocking=True)
                dev_s = time.perf_counter() - tic
            except BaseException:
                # a failed placement cannot leak the slot: that would
                # deadlock the NEXT get() instead of erroring
                ring.release(slot)
                raise
        return StagedCohort(t, clients, batches, masks, ids, host_s, dev_s,
                            event, lambda: ring.release(slot))

    def stage_blocking(self, t: int) -> StagedCohort:
        """Stage round t inline on the caller's thread (out-of-order
        rounds allowed), supervised like the ring. Reuses one private
        slot — valid because the caller synchronizes each round before
        staging the next."""
        tic = time.perf_counter()
        while True:
            try:
                self._crash_check(t)
                clients, batches, masks, ids = self._stage_host(
                    t, self._blocking_slot)
                break
            except Exception:
                if self._blocking_restarts >= self.max_restarts:
                    raise
                attempt = self._attempts.get(t, 1) - 1
                self._blocking_restarts += 1
                self._blocking_rounds[t] = self._blocking_rounds.get(t, 0) + 1
                if self.restart_backoff > 0:
                    time.sleep(self.restart_backoff * (2 ** attempt))
        self._sampled.pop(t, None)
        self._attempts.pop(t, None)
        host_s = time.perf_counter() - tic
        tic = time.perf_counter()
        batches, masks, ids, event = self._place(
            self._blocking_slot, batches, masks, ids, blocking=True)
        dev_s = time.perf_counter() - tic
        return StagedCohort(t, clients, batches, masks, ids, host_s, dev_s,
                            event)

    # ---- lifecycle ----

    @property
    def started(self) -> bool:
        """True once the staging ring exists (some round was prefetched)."""
        return self._ring is not None

    @property
    def restart_count(self) -> int:
        """Supervised producer recoveries so far (the ring's and
        stage_blocking's)."""
        ring = self._ring.restart_count if self._ring is not None else 0
        return ring + self._blocking_restarts

    def restarts_for(self, t: int) -> int:
        """Recoveries attributed to round ``t``'s STAGING (keyed by the
        staged round, not by whichever round was computing when the crash
        fired); final once round t has been handed out, which is when the
        trainer reads it for RoundRecord.ingest_restarts."""
        ring = (self._ring.restart_rounds.get(t, 0)
                if self._ring is not None else 0)
        return ring + self._blocking_rounds.get(t, 0)

    def close(self):
        """Stop the staging ring. The source is the caller's and is never
        closed here."""
        if self._ring is not None:
            self._ring.stop()
