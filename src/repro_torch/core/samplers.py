"""Pluggable client-participation samplers — a copy of
repro/core/samplers.py (numpy only) holding the classes this slice runs:
``ClientSampler`` and ``UniformSampler``.

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

from typing import Dict

import numpy as np


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
