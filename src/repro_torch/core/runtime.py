"""Pluggable client runtime models — the ARRIVAL axis of partial
participation; a copy of repro/core/runtime.py (numpy only).

The samplers (core/samplers.py) decide WHO participates each wave; a
``ClientRuntimeModel`` decides WHEN each sampled client's update comes
back, and whether it comes back at all. The buffered-async engine
(core/async_engine.py) turns those latencies into a virtual-time
arrival stream: updates computed against a wave's params snapshot land
in the server buffer out of order, and their staleness is whatever the
arrival order made it.

The regimes mirror the partial-participation literature's catalog
(arXiv:2506.02887; FedBuff's staleness model, arXiv:2106.06639):

    deterministic   every client takes the same fixed time — arrivals
                    keep wave order, staleness is identically zero at
                    concurrency 1 (the sync-equivalence anchor)
    exponential     i.i.d. exponential latencies + Bernoulli dropout —
                    the classic memoryless straggler model
    heavytail       Pareto latencies — a fat tail of stragglers whose
                    stale updates the staleness discount must tame
    markov          per-client fast/slow Markov chain — device state
                    (charging vs busy) persists across waves, so
                    slowness is CORRELATED per client; the chain is
                    runtime STATE

Contract (same round-order RNG discipline as the samplers):

  * ``draw(rng, wave, clients) -> (latencies, dropped)`` consumes a
    FIXED number of draws per call for a given model class — the
    trainer calls it in wave order, right after the sampler's draw for
    the same wave, so the port's schedule is the reference's draw for
    draw. ``DeterministicRuntime`` consumes ZERO draws, which is what
    keeps the async schedule equal to the sync schedule at the anchor
    (B = K, concurrency 1).
  * latencies are positive float64 virtual seconds, shape (len(clients),);
    ``dropped`` is a bool mask — dropped clients never reach the buffer
    (their compute is wasted, exactly the failure mode FedBuff models).
  * models with internal evolution expose ``state_dict``/
    ``load_state_dict``; ``config_dict`` echoes the constructor
    parameterization for the resume-compat check, mirroring
    ``ClientSampler``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ClientRuntimeModel:
    """Protocol + base class: subclass and implement ``draw``."""

    def draw(self, rng: np.random.RandomState, wave: int,
             clients: np.ndarray):
        """-> (latencies float64 (k,), dropped bool (k,))."""
        raise NotImplementedError

    # ---- checkpointing (stateless models need nothing) ----

    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass

    def config_dict(self) -> Dict:
        return {"class": type(self).__name__}


class DeterministicRuntime(ClientRuntimeModel):
    """Every client takes exactly ``latency`` virtual seconds; nobody
    drops. Consumes ZERO RNG draws — the async engine's wave order is
    then the arrival order (the seq tiebreak in the virtual-time heap),
    so at concurrency 1 the buffered-async run is draw-for-draw AND
    arrival-for-arrival identical to the synchronous run: the
    staleness-0 / B=K anchor cell of the regime matrix."""

    def __init__(self, latency: float = 1.0):
        if not latency > 0:
            raise ValueError(f"latency must be positive, got {latency}")
        self.latency = float(latency)

    def draw(self, rng, wave, clients):
        k = len(clients)
        return (np.full(k, self.latency, np.float64),
                np.zeros(k, bool))

    def config_dict(self):
        return {**super().config_dict(), "latency": self.latency}


class ExponentialRuntime(ClientRuntimeModel):
    """I.i.d. exponential latencies (mean ``mean``) with Bernoulli
    dropout — the memoryless straggler model. Consumes exactly TWO rng
    draws per wave (one latency vector, one dropout vector; the dropout
    draw happens even at dropout=0.0 so the draw count is
    config-independent)."""

    def __init__(self, mean: float = 1.0, dropout: float = 0.0):
        if not mean > 0:
            raise ValueError(f"mean latency must be positive, got {mean}")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.mean = float(mean)
        self.dropout = float(dropout)

    def draw(self, rng, wave, clients):
        k = len(clients)
        lat = rng.exponential(self.mean, size=k)
        dropped = rng.rand(k) < self.dropout
        return np.maximum(lat, 1e-9), dropped

    def config_dict(self):
        return {**super().config_dict(),
                "mean": self.mean, "dropout": self.dropout}


class HeavyTailRuntime(ClientRuntimeModel):
    """Pareto(shape) latencies scaled by ``scale`` — a fat straggler
    tail (smaller ``shape`` = fatter tail; shape <= 1 has infinite
    mean). Latency = scale * (1 + Pareto(shape)) >= scale, so the
    fastest client still pays the floor. Consumes exactly TWO rng draws
    per wave, like ``ExponentialRuntime``."""

    def __init__(self, shape: float = 1.5, scale: float = 1.0,
                 dropout: float = 0.0):
        if not shape > 0:
            raise ValueError(f"pareto shape must be positive, got {shape}")
        if not scale > 0:
            raise ValueError(f"scale must be positive, got {scale}")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.shape = float(shape)
        self.scale = float(scale)
        self.dropout = float(dropout)

    def draw(self, rng, wave, clients):
        k = len(clients)
        lat = self.scale * (1.0 + rng.pareto(self.shape, size=k))
        dropped = rng.rand(k) < self.dropout
        return lat, dropped

    def config_dict(self):
        return {**super().config_dict(), "shape": self.shape,
                "scale": self.scale, "dropout": self.dropout}


class MarkovRuntime(ClientRuntimeModel):
    """Per-client two-state fast/slow Markov chain over ALL
    ``num_clients`` clients: a slow client (busy device, bad link)
    tends to STAY slow across waves, so straggling is correlated per
    client rather than i.i.d. — the regime where staleness concentrates
    on a fixed subset and uniform discounts are most stressed.

    Per wave, consumes exactly THREE rng draws: one (num_clients,)
    uniform vector evolving the whole chain (participants and
    bystanders alike, so the trajectory is independent of who was
    sampled), one latency vector, one dropout vector. The chain state
    is checkpointed via ``state_dict`` — resuming mid-run continues the
    exact trajectory."""

    def __init__(self, num_clients: int, fast: float = 1.0,
                 slow: float = 4.0, p_slow: float = 0.2,
                 p_fast: float = 0.5, dropout: float = 0.0):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if not (0 < fast <= slow):
            raise ValueError(f"need 0 < fast <= slow, got {(fast, slow)}")
        if not (0.0 <= p_slow <= 1.0 and 0.0 < p_fast <= 1.0):
            raise ValueError((p_slow, p_fast))
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.num_clients = int(num_clients)
        self.fast = float(fast)
        self.slow = float(slow)
        self.p_slow = float(p_slow)      # fast -> slow transition prob
        self.p_fast = float(p_fast)      # slow -> fast transition prob
        self.dropout = float(dropout)
        self._slow_state: Optional[np.ndarray] = None   # (n,) bool

    def draw(self, rng, wave, clients):
        u = rng.rand(self.num_clients)
        if self._slow_state is None:
            # stationary distribution of the fast/slow chain
            pi = self.p_slow / max(self.p_slow + self.p_fast, 1e-12)
            self._slow_state = u < pi
        else:
            s = self._slow_state
            self._slow_state = np.where(s, u >= self.p_fast, u < self.p_slow)
        base = np.where(self._slow_state[np.asarray(clients, np.int64)],
                        self.slow, self.fast)
        lat = base * rng.exponential(1.0, size=len(clients))
        dropped = rng.rand(len(clients)) < self.dropout
        return np.maximum(lat, 1e-9), dropped

    def state_dict(self):
        return {} if self._slow_state is None else {
            "slow": self._slow_state.astype(np.uint8).tolist()}

    def load_state_dict(self, state):
        self._slow_state = (
            np.asarray(state["slow"], np.uint8).astype(bool)
            if state.get("slow") is not None else None)

    def config_dict(self):
        return {**super().config_dict(), "num_clients": self.num_clients,
                "fast": self.fast, "slow": self.slow,
                "p_slow": self.p_slow, "p_fast": self.p_fast,
                "dropout": self.dropout}


def make_runtime(name: str, num_clients: int, **kwargs
                 ) -> ClientRuntimeModel:
    """Build a runtime model by registry name (launch/train.py's
    ``--runtime`` flag and the bench sweep go through here)."""
    if name == "deterministic":
        return DeterministicRuntime(**kwargs)
    if name == "exponential":
        return ExponentialRuntime(**kwargs)
    if name == "heavytail":
        return HeavyTailRuntime(**kwargs)
    if name == "markov":
        return MarkovRuntime(num_clients, **kwargs)
    raise ValueError(f"unknown runtime model {name!r}; expected one of "
                     "deterministic/exponential/heavytail/markov")


def runtime_matrix(num_clients: int) -> Dict[str, ClientRuntimeModel]:
    """One representatively-configured instance of every runtime model
    — the arrival axis of the async bench sweep and the property tests.
    Exponential/heavytail carry real dropout so the drop path is
    exercised; markov uses a sticky slow state so correlation shows."""
    return {
        "deterministic": DeterministicRuntime(latency=1.0),
        "exponential": ExponentialRuntime(mean=1.0, dropout=0.1),
        "heavytail": HeavyTailRuntime(shape=1.2, scale=0.5, dropout=0.05),
        "markov": MarkovRuntime(num_clients, fast=0.5, slow=4.0,
                                p_slow=0.3, p_fast=0.4, dropout=0.05),
    }
