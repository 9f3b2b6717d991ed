"""Run-health monitor over the RoundRecord stream — a copy of
repro/health/monitor.py (pure Python: the port keeps its own copy,
so nothing of the reference package is imported).

Long unattended runs need automated judgment calls, not just per-round
receipts: a loss spike, a NaN, a staleness ramp, or a rising quarantine
rate each want an alarm (and, configured, an early stop) the moment
they appear — hours before a human reads the bench receipts. The
monitor is a pure host-side consumer of the ``RoundRecord`` stream the
trainer already emits, so it works identically under every execution
regime (serial / vectorized / sharded / buffered-async) and never
touches the compiled round.

Detectors (all windowed over the last ``window`` consumed rounds):

  loss spike      train_loss > spike_mult x rolling MEDIAN loss (the
                  median ignores the spike itself — a mean would chase
                  it), armed once ``min_history`` rounds are in window
  non-finite      train_loss NaN/inf — always an alarm, no warm-up
  staleness trend staleness_mean > staleness_mult x rolling median
                  staleness (buffered-async regime; a deepening queue
                  shows up here rounds before the loss does)
  quarantine rate mean quarantined-per-round over the window exceeds
                  ``quarantine_rate`` x clients_per_round — the guard
                  is eating a sustained fraction of the cohort

``observe(record)`` returns a ``HealthReport``; ``should_stop`` goes
True after ``patience`` CONSECUTIVE alarmed rounds (None disables the
early-stop hook; non-finite loss trips it immediately when
``stop_on_nonfinite``). State is a plain dict of floats/ints —
``state_dict()/load_state_dict()`` round-trip it bitwise through the
trainer's aux sidecar so a resumed run's detector picks up mid-window
instead of re-warming blind.

Verdicts can STREAM to an external tracker through a pluggable ``sink``
with the wandb-style interface ``log(data: dict, step: int)`` (plus an
optional ``close()``): every observe() emits its report as a flat dict,
so an unattended run's health trace lands somewhere a human (or a
dashboard) watches while the run is still going — not only in the
receipts read after the fact. ``JsonlHealthSink`` is the file-backed
reference implementation (one JSON object per line, append-only,
flushed per verdict so a crashed run keeps everything emitted); a real
``wandb.run`` object satisfies the same duck type directly. Sink
failures never take the training loop down — they disable the sink and
warn once.
"""
from __future__ import annotations

import json
import math
import warnings
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class HealthConfig:
    window: int = 32            # rolling-median window (rounds)
    min_history: int = 8        # rounds before the ratio alarms arm
    spike_mult: float = 3.0     # loss spike: > mult x median loss
    staleness_mult: float = 3.0  # staleness trend: > mult x median
    quarantine_rate: float = 0.25  # sustained quarantined / cohort
    clients_per_round: int = 10    # normalizes the quarantine rate
    patience: Optional[int] = None  # consecutive alarmed rounds -> stop
    stop_on_nonfinite: bool = True  # NaN/inf loss stops immediately

    def config_dict(self) -> Dict[str, Any]:
        return {"window": self.window, "min_history": self.min_history,
                "spike_mult": self.spike_mult,
                "staleness_mult": self.staleness_mult,
                "quarantine_rate": self.quarantine_rate,
                "clients_per_round": self.clients_per_round,
                "patience": self.patience,
                "stop_on_nonfinite": self.stop_on_nonfinite}


@dataclass
class HealthReport:
    """One round's verdict + the monitor's running tallies."""
    round: int
    train_loss: float
    loss_median: float            # rolling median BEFORE this round
    alarms: List[str] = field(default_factory=list)
    should_stop: bool = False
    # cumulative counters (whole run, survive resume)
    spike_rounds: int = 0
    nonfinite_rounds: int = 0
    alarmed_rounds: int = 0
    consecutive_alarmed: int = 0

    @property
    def healthy(self) -> bool:
        return not self.alarms


def _median(values) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        return math.nan
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class JsonlHealthSink:
    """Append-only JSONL tracker file: one verdict per line, flushed
    immediately (a killed run keeps every verdict emitted before the
    kill). The file opens lazily at the first ``log`` so constructing a
    monitor with a sink configured but never observed leaves no file."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = None

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        row = {"step": step, **data} if step is not None else dict(data)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class HealthMonitor:
    """Feed every consumed RoundRecord (in round order) to ``observe``;
    read the verdict from the returned HealthReport (also kept as
    ``last_report``). Host-side and regime-agnostic by construction.

    ``sink``: optional wandb-style tracker (``log(data, step)``); every
    report streams to it as a flat dict keyed by the report fields,
    with the alarm list joined to a comma string (flat scalar values
    only — the common denominator of tracker backends)."""

    def __init__(self, config: Optional[HealthConfig] = None, *,
                 sink=None):
        self.config = config or HealthConfig()
        self._sink = sink
        w = self.config.window
        self._loss = deque(maxlen=w)
        self._stale = deque(maxlen=w)
        self._quar = deque(maxlen=w)
        self._spike_rounds = 0
        self._nonfinite_rounds = 0
        self._alarmed_rounds = 0
        self._streak = 0              # consecutive alarmed rounds
        self._stopped = False
        self.last_report: Optional[HealthReport] = None

    # ---- detection ----

    def observe(self, record) -> HealthReport:
        """record: anything with .round/.train_loss/.staleness_mean/
        .quarantined (a RoundRecord). Returns this round's report."""
        cfg = self.config
        loss = float(record.train_loss)
        loss_med = _median(self._loss)
        alarms: List[str] = []
        if not math.isfinite(loss):
            alarms.append("nonfinite_loss")
            self._nonfinite_rounds += 1
        elif (len(self._loss) >= cfg.min_history
                and math.isfinite(loss_med)
                and loss > cfg.spike_mult * max(loss_med, 1e-12)):
            alarms.append("loss_spike")
            self._spike_rounds += 1
        stale = float(getattr(record, "staleness_mean", 0.0))
        stale_med = _median(self._stale)
        if (len(self._stale) >= cfg.min_history
                and math.isfinite(stale_med)
                and stale > cfg.staleness_mult * max(stale_med, 1e-12)):
            alarms.append("staleness_trend")
        quar = float(getattr(record, "quarantined", 0))
        self._quar.append(quar)
        if (len(self._quar) >= cfg.min_history
                and (sum(self._quar) / len(self._quar))
                > cfg.quarantine_rate * cfg.clients_per_round):
            alarms.append("quarantine_rate")
        # a non-finite loss never enters the median window (it would
        # poison every later comparison); spikes DO enter — a sustained
        # plateau at the new level stops alarming once the median catches
        # up, which is what distinguishes a spike from a regime change
        if math.isfinite(loss):
            self._loss.append(loss)
        self._stale.append(stale)
        if alarms:
            self._alarmed_rounds += 1
            self._streak += 1
        else:
            self._streak = 0
        stop = self._stopped
        if cfg.stop_on_nonfinite and "nonfinite_loss" in alarms:
            stop = True
        if cfg.patience is not None and self._streak >= cfg.patience:
            stop = True
        self._stopped = stop
        self.last_report = HealthReport(
            round=int(record.round), train_loss=loss, loss_median=loss_med,
            alarms=alarms, should_stop=stop,
            spike_rounds=self._spike_rounds,
            nonfinite_rounds=self._nonfinite_rounds,
            alarmed_rounds=self._alarmed_rounds,
            consecutive_alarmed=self._streak)
        if self._sink is not None:
            row = asdict(self.last_report)
            row["alarms"] = ",".join(alarms)
            row["healthy"] = not alarms
            try:
                self._sink.log(row, step=self.last_report.round)
            except Exception as e:       # pragma: no cover - defensive
                # a broken tracker must not take the run down: drop the
                # sink and keep training (the receipt path still records
                # everything)
                self._sink = None
                warnings.warn(f"health sink failed and was disabled: {e}",
                              RuntimeWarning, stacklevel=2)
        return self.last_report

    def close_sink(self) -> None:
        """Release the sink's file handle (if it has one)."""
        if self._sink is not None and hasattr(self._sink, "close"):
            self._sink.close()

    # ---- checkpointing (rides the trainer's aux sidecar) ----

    def state_dict(self) -> Dict[str, Any]:
        return {"loss": list(self._loss), "stale": list(self._stale),
                "quar": list(self._quar),
                "spike_rounds": self._spike_rounds,
                "nonfinite_rounds": self._nonfinite_rounds,
                "alarmed_rounds": self._alarmed_rounds,
                "streak": self._streak, "stopped": self._stopped}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        w = self.config.window
        self._loss = deque([float(x) for x in state["loss"]], maxlen=w)
        self._stale = deque([float(x) for x in state["stale"]], maxlen=w)
        self._quar = deque([float(x) for x in state["quar"]], maxlen=w)
        self._spike_rounds = int(state["spike_rounds"])
        self._nonfinite_rounds = int(state["nonfinite_rounds"])
        self._alarmed_rounds = int(state["alarmed_rounds"])
        self._streak = int(state["streak"])
        self._stopped = bool(state["stopped"])
