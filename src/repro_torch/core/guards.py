"""Update quarantine for arriving client deltas; a copy of
repro/core/guards.py (numpy only).

One NaN client poisons every mean-style server rule, and FedDPC is worse:
a non-finite or exploded delta enters the projection geometry (the
<Δ,Δ_prev> reduction) and corrupts Δ_prev for every later round. The
``UpdateGuard`` validates deltas before aggregation (core/round.py
``apply_guard``):

  quarantine   non-finite entries, or ||Δ|| above ``quarantine_mult`` x
               the rolling robust threshold → the client's delta is
               ZEROED (0 x NaN = NaN, so masking alone is not enough),
               its id is replaced by an out-of-range sentinel, and its
               row folds into the round's ``client_mask``.
  clip         finite deltas with ||Δ|| above ``clip_mult`` x threshold
               are scaled down to the clip limit.

The threshold is the MEDIAN of a rolling window of accepted norms —
robust: a burst of exploded updates cannot drag it up, because rejected
norms never enter the window. While fewer than ``min_history`` norms
have been accepted the threshold is +inf: nothing quarantines by norm
(non-finite always quarantines), nothing clips, and every multiplier is
exactly 1.0 — a guarded run with no faults is the unguarded run.

The per-row reduction (||Δ||² with non-finite entries zeroed, and the
non-finite count) is the ``feddpc_guard_dots`` kernel on the card.

The window lives on the host, in the trainer: rounds take the threshold
as a scalar and return the accepted norms, which the guard observes in
round order.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class GuardConfig:
    quarantine_mult: float = 1e3     # ||Δ|| > mult x thresh → quarantine
    clip_mult: float = 1e2           # ||Δ|| > mult x thresh → clip to limit
    window: int = 64                 # rolling accepted-norm window size
    min_history: int = 8             # threshold is +inf below this count

    def config_dict(self) -> dict:
        return {"quarantine_mult": self.quarantine_mult,
                "clip_mult": self.clip_mult, "window": self.window,
                "min_history": self.min_history}


class UpdateGuard:
    """Host-side rolling robust threshold over accepted update norms."""

    def __init__(self, config: GuardConfig = GuardConfig()):
        self.config = config
        self._norms: deque = deque(maxlen=int(config.window))
        self.total_quarantined = 0
        self.total_clipped = 0

    def threshold(self) -> float:
        """Median of the accepted-norm window; +inf until min_history
        norms have been observed (cold-start: quarantine only on
        non-finite, never on norm)."""
        if len(self._norms) < self.config.min_history:
            return float("inf")
        return float(np.median(np.asarray(self._norms)))

    def observe(self, accepted_norms: Sequence[float],
                quarantined: int = 0, clipped: int = 0) -> None:
        """Fold one consumed round's ACCEPTED (non-quarantined, real-row)
        norms into the window, in round order."""
        for n in np.asarray(accepted_norms, np.float64).ravel():
            if np.isfinite(n):
                self._norms.append(float(n))
        self.total_quarantined += int(quarantined)
        self.total_clipped += int(clipped)

    # ---- checkpoint round-trip (resume must be bitwise) ----

    def state_dict(self) -> dict:
        return {"norms": [float(n) for n in self._norms],
                "total_quarantined": int(self.total_quarantined),
                "total_clipped": int(self.total_clipped)}

    def load_state_dict(self, state: dict) -> None:
        self._norms = deque(state["norms"], maxlen=int(self.config.window))
        self.total_quarantined = int(state.get("total_quarantined", 0))
        self.total_clipped = int(state.get("total_clipped", 0))
