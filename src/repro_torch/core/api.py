"""FederatedTrainer — the simulation-mode FL driver that reproduces the
paper; counterpart of the part of repro/core/api.py the quickstart uses.

The trainer drives three pluggable pieces through one loop:

  ClientSampler (core/samplers.py)   WHO participates each round, drawn
      from the trainer's ``np.random.RandomState(seed)`` in round order —
      the same draws as the reference for the same seed;
  DataSource (ingest/sources.py)     WHERE batches come from:
      ``source.client_batches(client, round)``;
  the algorithm registry (core/baselines.py)   HOW updates aggregate.

Parameters live in one flat f32 buffer on the trainer's device
(``self.flat``; ``self.params`` is the tree of views into it). The
default round is cohort-vectorized (core/round.py): the K clients'
padded minibatch stacks go to the device as one (K, M, ...) batch and
local training runs for all of them at once; ``vectorize=False`` keeps
the one-client-at-a-time reference path.

Shape bucketing: M is padded to the cohort max and only grows, as in
the reference, so later rounds with fewer batches reuse the bucket.

Staging is blocking: each round's cohort is sampled, read and stacked
on the host, then copied to the device from pinned memory. The
reference's prefetch ring, async eval, checkpoints and chaos layer are
not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import client as client_mod
from repro_torch.core.baselines import ServerAlgo, make_algorithm
from repro_torch.core.round import make_cohort_round
from repro_torch.core.samplers import ClientSampler, UniformSampler
from repro_torch.ingest.sources import DataSource, as_data_source
from repro_torch.ingest.stack import stack_batches, stack_cohort


@dataclass
class AlgoConfig:
    """WHAT to optimize: the server rule + its hyperparameters."""
    name: str = "feddpc"
    eta_l: float = 0.1               # client learning rate
    eta_g: float = 1.0               # server learning rate
    local_optimizer: str = "sgd"
    hyper: Any = None


@dataclass
class ExecConfig:
    """HOW to run it."""
    rounds: int = 50
    clients_per_round: int = 10
    seed: int = 0
    eval_every: int = 5
    vectorize: bool = True           # cohort-vectorized round (default)


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_accuracy: Optional[float] = None
    seconds: float = 0.0
    diagnostics: Dict[str, float] = field(default_factory=dict)


def resolve_device(device=None) -> torch.device:
    """None means the card. Asking for CUDA where there is none raises —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _to_device(tree, device: torch.device):
    """Host numpy tree -> tensors on ``device``; to the card through
    pinned memory with a non-blocking copy."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return bridge.tree_map(put, tree)


class FederatedTrainer:
    """loss_fn(params_tree, batch) -> scalar; eval_fn(params_tree) ->
    accuracy. ``params`` is a parameter tree (numpy or torch leaves),
    copied into the trainer's flat buffer. ``data`` is a DataSource or a
    ``batch_fn(client, round) -> list`` callable. ``device=None`` means
    "cuda" and raises when CUDA is absent."""

    def __init__(self, loss_fn: Callable, params, num_clients: int, data,
                 cfg: Optional[ExecConfig] = None,
                 eval_fn: Optional[Callable] = None, *,
                 algo: Optional[AlgoConfig] = None,
                 sampler: Optional[ClientSampler] = None, device=None):
        self.device = resolve_device(device)
        # The reference computes in full f32. cuDNN's TF32 default for
        # convolutions would put the card's losses about three digits
        # away from it, so TF32 is off for matmuls and convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg if cfg is not None else ExecConfig()
        self.algo_cfg = algo if algo is not None else AlgoConfig()
        self.flat, self.layout = bridge.load_params(params, self.device)
        self.num_clients = num_clients
        self.source: DataSource = as_data_source(data)
        self.eval_fn = eval_fn
        self.sampler: ClientSampler = sampler if sampler is not None else \
            UniformSampler(num_clients, self.cfg.clients_per_round)
        self.algo: ServerAlgo = make_algorithm(self.algo_cfg.name,
                                               self.algo_cfg.hyper)
        self.server_state = self.algo.init(self.flat, num_clients)
        self._cohort_round = make_cohort_round(
            loss_fn, self.layout, self.algo, self.algo_cfg.eta_l,
            self.algo_cfg.eta_g, optimizer=self.algo_cfg.local_optimizer)
        self.local_update = client_mod.make_local_update(
            loss_fn, self.layout, self.algo_cfg.eta_l,
            optimizer=self.algo_cfg.local_optimizer)
        self.rng = np.random.RandomState(self.cfg.seed)
        self.history: List[RoundRecord] = []
        self.schedule: List[np.ndarray] = []     # sampled cohort per round
        self._max_batches: Optional[int] = None  # grow-once M bucket

    @property
    def params(self):
        """The parameter tree: views into the flat buffer."""
        return self.layout.unflatten(self.flat)

    # ---- internals ----

    def _sample_clients(self, t: int) -> np.ndarray:
        clients = np.asarray(self.sampler.sample(self.rng, t))
        k = self.cfg.clients_per_round
        if clients.shape != (k,):
            raise ValueError(
                f"sampler returned shape {clients.shape}; the cohort "
                f"round needs exactly clients_per_round={k} ids")
        if clients.min() < 0 or clients.max() >= self.num_clients:
            raise ValueError(f"sampler returned out-of-range ids "
                             f"(num_clients={self.num_clients})")
        if len(np.unique(clients)) != k:
            raise ValueError(f"sampler returned duplicate client ids: "
                             f"{clients.tolist()}")
        self.schedule.append(clients)
        return clients

    def _client_lists(self, clients: Sequence[int], t: int):
        """Read each sampled client's batches for round t and grow the M
        bucket to the cohort max."""
        per_client = [list(self.source.client_batches(int(c), t))
                      for c in clients]
        mx = max(len(b) for b in per_client)
        if self._max_batches is None or mx > self._max_batches:
            self._max_batches = mx
        return per_client

    def _run_round_vectorized(self, t: int):
        clients = self._sample_clients(t)
        batches, masks = stack_cohort(self._client_lists(clients, t),
                                      self._max_batches)
        batches, masks = _to_device((batches, masks), self.device)
        ids = torch.as_tensor(clients, dtype=torch.int32, device=self.device)
        self.flat, self.server_state, losses, diag = self._cohort_round(
            self.server_state, self.flat, batches, masks, ids)
        return float(losses.mean()), diag

    def _run_round_serial(self, t: int):
        clients = self._sample_clients(t)
        lists = self._client_lists(clients, t)
        deltas = torch.empty((len(clients), self.layout.size),
                             dtype=torch.float32, device=self.device)
        losses = []
        for j, blist in enumerate(lists):
            batches, mask = _to_device(
                stack_batches(blist, self._max_batches), self.device)
            _, loss = self.local_update(self.flat, batches, mask,
                                        out=deltas[j])
            losses.append(float(loss))
        ids = torch.as_tensor(clients, dtype=torch.int32, device=self.device)
        self.flat, self.server_state, diag = self.algo.step(
            self.server_state, self.flat, deltas, ids, self.algo_cfg.eta_g, 0)
        return float(np.mean(losses)), diag

    # ---- public ----

    def evaluate(self) -> float:
        with torch.no_grad():
            return float(self.eval_fn(self.params))

    def run_round(self, t: int) -> RoundRecord:
        tic = time.perf_counter()
        run = (self._run_round_vectorized if self.cfg.vectorize
               else self._run_round_serial)
        train_loss, diag = run(t)          # reads the losses: syncs
        rec = RoundRecord(round=t, train_loss=train_loss,
                          seconds=time.perf_counter() - tic,
                          diagnostics={k: float(v) for k, v in diag.items()})
        if self.eval_fn and (t % self.cfg.eval_every == 0
                             or t == self.cfg.rounds - 1):
            rec.test_accuracy = self.evaluate()
        self.history.append(rec)
        return rec

    def run(self, verbose: bool = False) -> List[RoundRecord]:
        for t in range(len(self.history), self.cfg.rounds):
            rec = self.run_round(t)
            if verbose:
                acc = ("" if rec.test_accuracy is None
                       else f"  acc={rec.test_accuracy:.4f}")
                print(f"[{self.algo.name}] round {t:4d} "
                      f"loss={rec.train_loss:.4f}{acc}")
        return self.history

    @property
    def best_accuracy(self):
        accs = [(r.test_accuracy, r.round) for r in self.history
                if r.test_accuracy is not None]
        return max(accs) if accs else (None, None)
