"""Buffered-async round engine — FedBuff-style streaming aggregation;
counterpart of repro/core/async_engine.py (FedBuff, arXiv:2106.06639).

The synchronous trainer steps the server once per fully-finished cohort;
under real partial participation stragglers hold every round hostage.
Here the cohort dispatches are WAVES: wave w's clients train against the
params snapshot current at dispatch time, their updates travel for
runtime-model latencies (core/runtime.py), and finished updates stream
into a server-side buffer as they arrive. Every ``buffer_size`` (B)
arrivals the server folds the buffer in one step; an update computed
against snapshot version v and folded at version t carries staleness
s = t - v and a discount weight

    w(s) = (1 + s) ** (-alpha)          (exactly 1.0 at s = 0)

folded into the aggregation — for FedDPC, multiplied into the adaptive
``scale`` so the projection geometry is computed on the raw delta and
only the applied magnitude is discounted; for mean-style rules,
pre-scaled onto the buffered deltas (the trainer's fold decides).

Time is VIRTUAL: a (finish_time, seq) min-heap orders arrivals, the
clock jumps to each pop, and latencies come from the runtime model's
draws, made in wave order right after the sampler's — so the whole async
trajectory is a pure function of (seed, configuration), the reference's
draw for draw. The ``seq`` tiebreak makes equal-latency arrivals pop in
dispatch order, which pins the anchor: DeterministicRuntime +
concurrency 1 + B = K gives arrival order == cohort order and staleness
identically 0, i.e. the synchronous round.

``concurrency`` bounds how many waves may be in flight at once; new
waves dispatch whenever the in-flight count drops below it (or the heap
runs dry), so higher concurrency trades staleness for utilization.

Entries keep ROWS of their wave's output (a view of the delta stack, or
the codec payload's row), so ``wave_update`` must hand each wave fresh
tensors: a stack reused by a later wave would overwrite buffered updates
that are still in flight.

Across the ranks of a multi-process job (``held_rows``) every rank runs
the same engine — the heap is a pure function of the seed, the sampler
and the runtime model, whose draws every rank makes alike — and keeps
every entry, but only the ranks whose client slice trained an update
hold its delta (rows [lo, hi) of each wave's padded stack, as
``wave_update`` returns them; the losses it returns cover the whole
wave). The fold gets the held arrivals and their buffer positions
(``held=``) instead of all B stacked.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.bridge import tree_map


@dataclass(order=False)
class BufferEntry:
    """One in-flight (or buffered) client update. ``version`` is the
    server-params version the delta was computed against; staleness at
    fold time is ``fold_version - version``. Ordered by (finish, seq)
    in the virtual-time heap — ``seq`` is a global dispatch counter, so
    equal finish times resolve in dispatch order (deterministic)."""
    client: int
    wave: int
    version: int
    seq: int
    finish: float          # virtual arrival time
    loss: float
    delta: Any             # one client's row: an (N,) tensor, or the
                           # codec payload's row {"q", "scale", "zero"};
                           # None on a rank that does not hold it


class BufferedAsyncEngine:
    """Virtual-time wave dispatcher + server-side arrival buffer.

    Collaborators (all trainer-owned):

      pipeline       ingest/pipeline.CohortIngestPipeline staging wave
                     cohorts in wave order: ``get(wave)`` from its ring
                     (``prefetch``) or ``stage_blocking(wave)`` -> a
                     StagedCohort
      wave_update    (params, server_state, batches, masks) ->
                     (deltas (K, ...), losses (K,)) — the cohort local
                     update against the CURRENT snapshot, in new tensors
      fold           (server_state, params, deltas (B, ...), ids (B,)
                     int32, weights (B,) f32, both numpy, *extras) ->
                     (new_params, new_state, diag[, guard_stats]); with
                     ``held_rows`` deltas are the held arrivals' rows
                     (None without any) and ``held=`` their positions
      runtime_take   wave -> (latencies (k,), dropped (k,)) — the
                     latency draws made at sampling time
      fold_extras    optional: the arrival list -> extra fold inputs
                     (the chaos layer's fault codes and guard threshold)
    """

    def __init__(self, *, pipeline, wave_update: Callable,
                 fold: Callable, runtime_take: Callable,
                 buffer_size: int, alpha: float = 0.5,
                 concurrency: int = 1, prefetch: bool = True,
                 deadline: float = None,
                 fold_extras: Callable = None,
                 fold_returns_stats: bool = False,
                 held_rows: Tuple[int, int] = None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if alpha < 0:
            raise ValueError(f"staleness alpha must be >= 0, got {alpha}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        self.pipeline = pipeline
        self.wave_update = wave_update
        self.fold = fold
        self.runtime_take = runtime_take
        self.buffer_size = int(buffer_size)
        self.alpha = float(alpha)
        self.concurrency = int(concurrency)
        self.prefetch = prefetch
        # round deadline in virtual seconds: stop collecting arrivals
        # once the next one would land more than ``deadline`` past the
        # round's start and fold the PARTIAL buffer (at least one
        # arrival always folds). Stragglers stay in flight and fold later
        # with their staleness discount; nothing is discarded.
        self.deadline = None if deadline is None else float(deadline)
        # chaos hooks (trainer-owned): fold_extras maps the arrivals to
        # extra fold inputs; fold_returns_stats marks a fold that returns
        # the guard's stats as a 4th element, surfaced in the metrics
        self.fold_extras = fold_extras
        self.fold_returns_stats = fold_returns_stats
        # a rank's rows [lo, hi) of every wave's padded stack (None: one
        # process, every row)
        self.held_rows = held_rows
        self.clock = 0.0               # virtual time of the last arrival
        self.seq = 0                   # global dispatch counter (tiebreak)
        self.wave_frontier = 0         # next wave to dispatch
        self.version = 0               # server folds performed so far
        self._heap: List[Tuple[float, int, BufferEntry]] = []

    # ---- wave dispatch ----

    def _live_waves(self) -> int:
        return len({e.wave for (_, _, e) in self._heap})

    def _dispatch_wave(self, params, server_state):
        """Stage + train the next wave against the current snapshot and
        push its surviving updates onto the arrival heap. Returns
        (n_pushed, host_seconds, device_seconds)."""
        w = self.wave_frontier
        staged = (self.pipeline.get(w) if self.prefetch
                  else self.pipeline.stage_blocking(w))
        try:
            staged.wait()
            deltas, losses = self.wave_update(
                params, server_state, staged.batches, staged.masks)
            # host read of the losses: waits for the wave's training
            losses_h = losses.detach().cpu().numpy().astype(np.float32)
            lat, dropped = self.runtime_take(w)
            lo, hi = self.held_rows or (0, len(staged.clients))
            pushed = 0
            for j in range(len(staged.clients)):
                if dropped[j]:
                    continue           # never arrives (wasted compute)
                entry = BufferEntry(
                    client=int(staged.clients[j]), wave=w,
                    version=self.version, seq=self.seq,
                    finish=self.clock + float(lat[j]),
                    loss=float(losses_h[j]),
                    delta=(tree_map(lambda x, r=j - lo: x[r], deltas)
                           if lo <= j < hi else None))
                heapq.heappush(self._heap,
                               (entry.finish, entry.seq, entry))
                self.seq += 1
                pushed += 1
        finally:
            staged.release()
        self.wave_frontier = w + 1
        return pushed, staged.host_seconds, staged.device_seconds

    # ---- server round ----

    def run_server_round(self, t: int, params, server_state):
        """Collect the next ``buffer_size`` arrivals (dispatching waves
        as concurrency allows) and fold them into one server step.
        Returns (new_params, new_server_state, metrics)."""
        arrivals: List[BufferEntry] = []
        host_s = dev_s = 0.0
        empty_streak = 0
        start_clock = self.clock
        deadline_fired = 0
        wave_start = self.wave_frontier
        shipped = 0                    # updates pushed in flight this round
        while len(arrivals) < self.buffer_size:
            # top up in-flight waves: always at least one pending
            # arrival, and up to `concurrency` waves in flight
            while not self._heap or self._live_waves() < self.concurrency:
                if self._heap and self._live_waves() >= self.concurrency:
                    break
                n, h, d = self._dispatch_wave(params, server_state)
                shipped += n
                host_s += h
                dev_s += d
                empty_streak = 0 if n else empty_streak + 1
                if empty_streak >= 100:
                    # dropout < 1 makes an endless all-dropped run a
                    # probability-zero event; a runtime model violating
                    # that surfaces here instead of spinning forever
                    raise RuntimeError(
                        f"{empty_streak} consecutive waves dropped every "
                        "client — runtime model starves the buffer")
            if (self.deadline is not None and arrivals
                    and self._heap[0][0] > start_clock + self.deadline):
                # partial-buffer fold: the next arrival would land past
                # the deadline — fold what we have; the stragglers stay
                # in flight and fold later, discounted
                deadline_fired = 1
                break
            finish, _, entry = heapq.heappop(self._heap)
            self.clock = max(self.clock, finish)
            arrivals.append(entry)
        stale = np.asarray([self.version - e.version for e in arrivals],
                           np.float64)
        # (1+s)^(-alpha) in float64, then f32: exactly 1.0 at s = 0
        weights = ((1.0 + stale) ** (-self.alpha)).astype(np.float32)
        ids = np.asarray([e.client for e in arrivals], np.int32)
        extras = self.fold_extras(arrivals) if self.fold_extras else ()
        held = [i for i, e in enumerate(arrivals) if e.delta is not None]
        stacked = (tree_map(lambda *xs: torch.stack(xs),
                            *[arrivals[i].delta for i in held])
                   if held else None)
        kw = ({} if self.held_rows is None
              else {"held": np.asarray(held, np.int64)})
        out = self.fold(server_state, params, stacked, ids, weights,
                        *extras, **kw)
        gstats = None
        if self.fold_returns_stats:
            params, server_state, diag, gstats = out
        else:
            params, server_state, diag = out
        self.version += 1
        metrics = {
            "train_loss": float(np.mean([e.loss for e in arrivals])),
            "staleness_mean": float(stale.mean()),
            "staleness_max": float(stale.max()),
            "diag": diag,
            "host_seconds": host_s,
            "device_seconds": dev_s,
            "n_arrivals": len(arrivals),
            "guard_stats": gstats,
            # uplink accounting: updates SHIPPED (pushed in flight) while
            # this round collected — bytes are paid at ship time whether
            # or not this fold consumed the update
            "n_shipped": shipped,
            "wave_start": wave_start,
            "wave_end": self.wave_frontier,
            "deadline_fired": deadline_fired,
            "deadline_dropped": (self.buffer_size - len(arrivals)
                                 if deadline_fired else 0),
        }
        return params, server_state, metrics

    # ---- checkpointing (driven by FederatedTrainer.save/restore) ----

    def inflight(self) -> List[BufferEntry]:
        """In-flight entries in (finish, seq) heap order — dispatched
        but not yet arrived/folded. The arrival buffer itself is always
        empty between rounds (run_server_round folds exactly what it
        collects), so this IS the full streaming state."""
        return [e for (_, _, e) in sorted(self._heap,
                                          key=lambda x: (x[0], x[1]))]

    def load_inflight(self, entries: List[BufferEntry]) -> None:
        self._heap = [(e.finish, e.seq, e) for e in entries]
        heapq.heapify(self._heap)
