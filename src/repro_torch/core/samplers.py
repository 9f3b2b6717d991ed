"""Pluggable client-participation samplers — a copy of
repro/core/samplers.py (numpy only): ``UniformSampler``,
``WeightedSampler``, ``CyclicSampler`` and ``MarkovSampler``, tested draw
for draw against the originals.

The paper's core claim is about *partial client participation*; which
clients show up each round is a modeling axis of its own (FedVARP's
uniform-without-replacement, size-weighted availability, cyclic block
schedules, Markov on/off availability — arXiv:2207.14130, 2506.02887).
``ClientSampler`` is the protocol the ``FederatedTrainer`` drives:

    sampler.sample(rng, round) -> (cohort_size,) int ndarray of client ids

Contract:
  * ``rng`` is the trainer's ``np.random.RandomState``.  Samplers draw
    from it IN ROUND ORDER (the cohort prefetcher stages rounds
    sequentially) and must consume the same draws for the same round
    regardless of prefetching — determinism is what makes a prefetched
    run reproduce a blocking one, and what makes checkpoint/resume
    reproduce an uninterrupted run.
  * The returned cohort has EXACTLY ``cohort_size`` distinct ids: the
    fused cohort round is one jit'd program per (K, M) shape bucket, so
    K must not vary across rounds.
  * Samplers with internal evolution (``MarkovSampler``'s availability
    vector) expose it via ``state_dict()``/``load_state_dict()`` so
    ``FederatedTrainer.save()`` can checkpoint mid-chain.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

import numpy as np


def _digest_p(p) -> str:
    """Canonical digest of a probability vector: sha256 over the
    float64 little-endian bytes."""
    arr = np.ascontiguousarray(np.asarray(p, np.float64))
    if arr.dtype.byteorder == ">":        # canonicalize on BE hosts
        arr = arr.astype("<f8")
    return hashlib.sha256(arr.tobytes()).hexdigest()


def normalize_sampler_config(cfg: Dict) -> Dict:
    """Resume-compat shim for sampler config echoes: sidecars written
    before WeightedSampler switched to digest+length carry the full
    ``"p"`` vector — rewrite them to the digest form so old checkpoints
    still compare equal against a live ``config_dict()``. Non-legacy
    configs pass through unchanged."""
    if "p" in cfg:
        cfg = dict(cfg)
        p = cfg.pop("p")
        cfg["p_digest"] = _digest_p(p)
        cfg["p_len"] = int(len(p))
    return cfg


class ClientSampler:
    """Protocol + base class: subclass and implement ``sample``."""

    num_clients: int
    cohort_size: int

    def sample(self, rng: np.random.RandomState, round: int) -> np.ndarray:
        raise NotImplementedError

    # ---- checkpointing (stateless samplers need nothing) ----

    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass

    def config_dict(self) -> Dict:
        """JSON echo of the CONSTRUCTOR parameterization (as opposed to
        the evolving ``state_dict``): ``FederatedTrainer.restore``
        compares it against the checkpointed echo so a resume with a
        differently-built sampler fails loudly instead of silently
        diverging. Subclasses with extra knobs must extend it."""
        return {"class": type(self).__name__,
                "num_clients": self.num_clients,
                "cohort_size": self.cohort_size}


class UniformSampler(ClientSampler):
    """Uniform without replacement — the paper's (and the seed repo's)
    participation model.  Draw-for-draw identical to the historical
    inlined ``FederatedTrainer._sample_clients``, which the old-vs-new
    surface equivalence test relies on."""

    def __init__(self, num_clients: int, cohort_size: int):
        if not 1 <= cohort_size <= num_clients:
            raise ValueError((cohort_size, num_clients))
        self.num_clients = num_clients
        self.cohort_size = cohort_size

    def sample(self, rng, round):
        return rng.choice(self.num_clients, size=self.cohort_size,
                          replace=False)


class WeightedSampler(ClientSampler):
    """Weighted-by-data-size (or any importance weight) participation
    without replacement: clients with more data are proportionally more
    likely to be available.  Zero-weight clients never participate."""

    def __init__(self, weights: Sequence[float], cohort_size: int):
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be a non-negative 1-D vector "
                             "with positive sum")
        if int((w > 0).sum()) < cohort_size:
            raise ValueError(f"only {int((w > 0).sum())} clients have "
                             f"positive weight; cannot draw {cohort_size}")
        self.num_clients = len(w)
        self.cohort_size = cohort_size
        self.p = w / w.sum()

    def sample(self, rng, round):
        return rng.choice(self.num_clients, size=self.cohort_size,
                          replace=False, p=self.p)

    def config_dict(self):
        # digest + length, NOT the raw vector: the echo lives in the
        # JSON checkpoint sidecar and is string-compared on every
        # resume — an O(num_clients) float list bloats both at scale.
        # sha256 over the canonical float64 bytes is exact (the vector
        # is already float64; JSON float round-trips are value-exact so
        # legacy sidecars normalize to the same digest).
        return {**super().config_dict(),
                "p_digest": _digest_p(self.p), "p_len": int(len(self.p))}


class CyclicSampler(ClientSampler):
    """Deterministic cyclic / block participation: round t takes the
    contiguous block starting at ``t * cohort_size (mod num_clients)``
    (arXiv:2506.02887's "cyclic" regime — every client participates at a
    fixed cadence; no RNG draws are consumed)."""

    def __init__(self, num_clients: int, cohort_size: int):
        if not 1 <= cohort_size <= num_clients:
            raise ValueError((cohort_size, num_clients))
        self.num_clients = num_clients
        self.cohort_size = cohort_size

    def sample(self, rng, round):
        start = (round * self.cohort_size) % self.num_clients
        return (start + np.arange(self.cohort_size)) % self.num_clients


class MarkovSampler(ClientSampler):
    """Two-state Markov availability per client (the intermittent-client
    regime): an available client drops out with prob ``p_off``, an
    unavailable one returns with prob ``p_on``; the cohort is drawn
    uniformly from the available set.  If fewer than ``cohort_size``
    clients are up, the shortfall is drafted uniformly from the
    unavailable ones so K stays constant (the jit shape bucket).

    The availability vector is sampler STATE and is checkpointed through
    ``state_dict`` — resuming mid-chain continues the exact trajectory.
    """

    def __init__(self, num_clients: int, cohort_size: int,
                 p_on: float = 0.5, p_off: float = 0.5):
        if not 1 <= cohort_size <= num_clients:
            raise ValueError((cohort_size, num_clients))
        if not (0.0 < p_on <= 1.0 and 0.0 <= p_off <= 1.0):
            raise ValueError((p_on, p_off))
        self.num_clients = num_clients
        self.cohort_size = cohort_size
        self.p_on = p_on
        self.p_off = p_off
        self._avail: Optional[np.ndarray] = None    # (n,) bool

    def sample(self, rng, round):
        if self._avail is None:
            # stationary distribution of the two-state chain
            pi = self.p_on / max(self.p_on + self.p_off, 1e-12)
            self._avail = rng.rand(self.num_clients) < pi
        else:
            u = rng.rand(self.num_clients)
            up = self._avail
            self._avail = np.where(up, u >= self.p_off, u < self.p_on)
        up_ids = np.flatnonzero(self._avail)
        down_ids = np.flatnonzero(~self._avail)
        k = self.cohort_size
        if len(up_ids) >= k:
            return rng.choice(up_ids, size=k, replace=False)
        drafted = rng.choice(down_ids, size=k - len(up_ids), replace=False)
        cohort = np.concatenate([up_ids, drafted])
        # RNG contract: the shortfall branch consumes exactly TWO draws
        # (choice + permutation) vs the normal branch's one. The shuffle
        # matters: returning sorted up_ids first leaked availability
        # through cohort position and gave the two branches different
        # padded-cohort layouts (position-sensitive downstream: pad
        # masks, per-slot diagnostics).
        return cohort[rng.permutation(k)]

    def state_dict(self):
        return {} if self._avail is None else {
            "avail": self._avail.astype(np.uint8).tolist()}

    def load_state_dict(self, state):
        self._avail = (np.asarray(state["avail"], np.uint8).astype(bool)
                       if state.get("avail") is not None else None)

    def config_dict(self):
        return {**super().config_dict(),
                "p_on": self.p_on, "p_off": self.p_off}


def sampler_matrix(num_clients: int, cohort_size: int
                   ) -> Dict[str, ClientSampler]:
    """One representatively-configured instance of every sampler — the
    participation axis of the reference's cross-regime equivalence
    matrix (tests/test_regime_matrix.py).  A NEW sampler class added to
    this module registers an instance here.
    Weighted uses size-proportional weights (1..n) so the draw is
    genuinely non-uniform; Markov uses asymmetric on/off rates so the
    availability chain actually evolves."""
    return {
        "uniform": UniformSampler(num_clients, cohort_size),
        "weighted": WeightedSampler(
            np.arange(1, num_clients + 1, dtype=np.float64), cohort_size),
        "cyclic": CyclicSampler(num_clients, cohort_size),
        "markov": MarkovSampler(num_clients, cohort_size,
                                p_on=0.7, p_off=0.4),
    }
