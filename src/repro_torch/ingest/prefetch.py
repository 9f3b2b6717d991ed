"""[Copy of repro/ingest/prefetch.py — pure Python, verbatim apart from
the producer's weak reference to its owner (below).]

Depth-N staging ring for cohort ingest (DESIGN.md §10; the depth-2
special case is the double-buffered prefetcher of DESIGN.md §2, moved
here from core/client.py).

A daemon thread runs ``produce_fn(t, slot)`` for t = start..end-1 IN
ROUND ORDER (so RNG-driven client sampling inside it draws the exact
same sequence as the blocking path), staging upcoming rounds into free
ring slots while the current round's program runs on device. With
``slots=N`` the producer runs up to N rounds ahead of the oldest
unreleased slot and never overwrites a buffer a round may still be
reading: the consumer releases a slot only after it has synchronized on
that round's results (on CPU backends a device-placed value may alias
the slot's host buffer — see ingest/placement.py — so placement alone
never frees a slot).

    item, slot = ring.get(t)   # blocks only until round t is staged
    ... dispatch + sync ...
    ring.release(slot)

``end=None`` runs the producer unbounded — the buffered-async engine
(core/async_engine.py) dispatches a dynamic number of waves, so the
horizon is open until ``stop()``; backpressure still comes from the
``slots`` free-list, so "unbounded" never stages more than ``slots``
rounds ahead.

The producer holds a bound-method ``produce_fn`` (the port's pipeline)
only weakly, so an owner dropped without ``stop()`` can still be
collected; its finalizer calls ``signal_stop()``, which ends the
producer without joining it. Device memory the staged rounds hold is
then released with them.
"""
from __future__ import annotations

import inspect
import itertools
import queue
import threading
import time
import traceback
import weakref
from typing import Optional


class CohortPrefetcher:
    """Ring of ``slots`` staging buffers filled in round order by a
    producer thread; ``slots=2`` double-buffers (the historical
    default), ``slots=1`` single-buffers (the producer still runs off
    the consumer thread, but can only work ahead while the consumer
    holds nothing — useful as the degenerate point of depth sweeps).

    ``stall_timeout`` (seconds, None = wait forever) bounds how long a
    ``get`` waits for a LIVE producer: a producer thread hung inside
    ``produce_fn`` (slow disk read, deadlocked source) previously spun
    the consumer forever — the 1s poll only escaped on a *dead* thread.
    With a deadline the consumer raises, naming the stuck round, so the
    caller can surface the hang instead of inheriting it.

    ``max_restarts`` supervises the producer (DESIGN.md §12): a
    ``produce_fn`` raise is retried for the SAME round up to
    ``max_restarts`` times total across the ring's lifetime, with
    bounded exponential backoff (``restart_backoff * 2**attempt``)
    between tries; ``restart_count`` tallies the recoveries. Past the
    budget the failure propagates exactly as before: the consumer's
    next ``get`` raises, carrying the producer's traceback text."""

    def __init__(self, produce_fn, start: int, end: Optional[int],
                 slots: int = 2, stall_timeout: Optional[float] = None,
                 max_restarts: int = 0, restart_backoff: float = 0.0):
        self._end = end
        self._stall_timeout = stall_timeout
        self._max_restarts = max(0, int(max_restarts))
        self._restart_backoff = float(restart_backoff)
        self.restart_count = 0
        # restarts keyed by the STAGED round whose produce_fn crashed —
        # the producer runs ahead of consumption, so a cumulative count
        # alone would let the consumer charge a crash during round t+1's
        # staging to whatever round happened to be observing (the round-
        # attribution bug of DESIGN.md §12's accounting)
        self.restart_rounds: dict = {}
        self._ready = queue.Queue()
        self._free = queue.Queue()
        self.slots = max(1, slots)
        for _ in range(self.slots):
            self._free.put({})
        self._exc = None
        self._exc_tb = None             # producer traceback text, for get()
        self._stopped = False
        produce_ref = (weakref.WeakMethod(produce_fn)
                       if inspect.ismethod(produce_fn)
                       else (lambda: produce_fn))
        self._thread = threading.Thread(
            target=self._loop, args=(produce_ref, start, end), daemon=True,
            name="cohort-prefetch")
        self._thread.start()

    def _loop(self, produce_ref, start, end):
        rounds = (range(start, end) if end is not None
                  else itertools.count(start))
        try:
            for t in rounds:
                slot = self._free.get()
                produce_fn = produce_ref()
                if slot is None or produce_fn is None:   # stopped, or
                    return                               # owner dropped
                item = self._produce_supervised(produce_fn, t, slot)
                del produce_fn
                self._ready.put((t, item, slot))
        except BaseException as e:      # surfaced on the next get()
            self._exc = e
            self._exc_tb = traceback.format_exc()
            self._ready.put((None, None, None))

    def _produce_supervised(self, produce_fn, t, slot):
        """Retry produce_fn(t, slot) against a lifetime restart budget.
        Backoff doubles per retry of the same round so a persistently
        failing source drains the budget slowly instead of hot-looping."""
        attempt = 0
        while True:
            try:
                return produce_fn(t, slot)
            except BaseException:
                if self.restart_count >= self._max_restarts:
                    raise
                self.restart_count += 1
                self.restart_rounds[t] = self.restart_rounds.get(t, 0) + 1
                if self._restart_backoff > 0:
                    time.sleep(self._restart_backoff * (2 ** attempt))
                attempt += 1

    def get(self, t: int):
        if self._end is not None and t >= self._end:
            raise RuntimeError(
                f"round {t} is past the configured horizon ({self._end} "
                "rounds were prefetched); raise ExecConfig.rounds or set "
                "ExecConfig.prefetch=False to run extra rounds")
        waited = 0.0
        poll = 1.0
        if self._stall_timeout is not None:
            poll = min(poll, max(self._stall_timeout / 4, 0.01))
        while True:
            try:
                got, item, slot = self._ready.get(timeout=poll)
                break
            except queue.Empty:
                # a dead producer with an empty queue would otherwise
                # hang forever (e.g. rounds re-run after a completed run)
                if not self._thread.is_alive():
                    try:
                        # drain once more: the producer's final put may
                        # have landed between the timeout and this check
                        got, item, slot = self._ready.get_nowait()
                        break
                    except queue.Empty:
                        raise RuntimeError(
                            f"prefetch producer exited (rounds consumed "
                            f"or stopped) — round {t} was never staged; "
                            "set ExecConfig.prefetch=False to re-run rounds"
                            + self._cause_suffix()) from self._exc
                waited += poll
                if (self._stall_timeout is not None
                        and waited >= self._stall_timeout):
                    # producer ALIVE but stuck inside produce_fn: raise
                    # with the stuck round instead of spinning forever
                    raise RuntimeError(
                        f"staging producer stalled: round {t} not staged "
                        f"after {waited:.1f}s (stall deadline "
                        f"{self._stall_timeout}s) — the producer thread is "
                        "alive but blocked inside produce_fn (slow or "
                        "deadlocked source read?)")
        if got is None:                 # producer-failure sentinel; a round
            # staged BEFORE the failure is still valid and returned above.
            # Re-poison so every later get() fails too instead of hanging.
            self._ready.put((None, None, None))
            # the producer's own traceback is re-raised inline: `from`
            # chaining alone loses the frames inside produce_fn when the
            # consumer's RuntimeError is caught and reported elsewhere
            raise RuntimeError("cohort prefetch thread failed"
                               + self._cause_suffix()) from self._exc
        if got != t:
            raise RuntimeError(
                f"prefetched round {got} but round {t} was requested — "
                "prefetching requires run_round(t) in sequential order "
                "(set ExecConfig.prefetch=False for out-of-order rounds)")
        return item, slot

    def _cause_suffix(self) -> str:
        """The producer's formatted traceback, for re-raise messages —
        the frames inside produce_fn are otherwise lost when the
        consumer-side RuntimeError is caught and reported elsewhere."""
        if self._exc_tb is None:
            return ""
        return "\nproducer traceback:\n" + self._exc_tb

    def release(self, slot: dict):
        self._free.put(slot)

    def signal_stop(self):
        """Ask the producer to end (without waiting for it) and drop every
        staged-but-unconsumed slot, so their buffers go with the ring
        instead of pinning whatever host/device memory the producer staged
        ahead. Safe from a finalizer on any thread."""
        if self._stopped:
            return
        self._stopped = True
        self._free.put(None)            # unblock the producer if waiting
        self._drain()

    def _drain(self):
        while True:                     # staged slots (and any poison
            try:                        # sentinel): nothing will consume
                self._ready.get_nowait()  # them after a stop
            except queue.Empty:
                break

    def stop(self, join_timeout: float = 5.0):
        """Stop the producer and reclaim its staging state: put the
        sentinel, JOIN the thread (bounded — a producer hung inside
        ``produce_fn`` is a daemon and cannot block interpreter exit),
        then drain every staged-but-unconsumed slot."""
        stopped = self._stopped
        self.signal_stop()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout)
        if not stopped:
            self._drain()               # what the producer put meanwhile
