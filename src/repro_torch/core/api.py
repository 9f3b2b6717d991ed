"""FederatedTrainer — the simulation-mode FL driver that reproduces the
paper; counterpart of the part of repro/core/api.py the quickstart, the
buffered-async regime, the delta codecs and the chaos layer use.

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

``ExecConfig.async_buffer`` switches to buffered-async rounds
(core/async_engine.py): cohorts become waves trained against possibly
stale snapshots, a runtime model (core/runtime.py, drawn right after the
sampler, wave by wave) decides when each update arrives, and the server
folds every ``buffer_size`` arrivals with staleness discounts. A lossy
codec (``codec``, repro_torch/codec) quantizes the uplink in either
regime, with optional error feedback (``codec_ef``).

Chaos hardening, as in the reference: a ``FaultPlan`` (core/faults.py)
injects NaN or exploded deltas after local training and hangs into the
runtime draws; ``ExecConfig.guard`` validates every delta before the
server rule (core/guards.py: quarantine non-finite or exploded rows,
clip outliers against a rolling median of accepted norms);
``ExecConfig.round_deadline`` drops and masks the clients of a sync
round whose runtime draw misses it (a runtime model is drawn for sync
rounds too), and makes the async engine fold a partial buffer.

Shape bucketing: M is padded to the cohort max and only grows, as in
the reference, so later rounds with fewer batches reuse the bucket.

Staging is blocking (ingest/pipeline.py): each round's cohort is
sampled, read and stacked on the host, then copied to the device from
pinned memory. The reference's prefetch ring, async eval, checkpoints
and edges are not ported yet; nor are the fault kinds that need them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.codec import make_codec
from repro_torch.core import client as client_mod
from repro_torch.core.async_engine import BufferedAsyncEngine
from repro_torch.core.baselines import ServerAlgo, make_algorithm
from repro_torch.core import projection as proj
from repro_torch.core.guards import GuardConfig, UpdateGuard
from repro_torch.core.round import (ID_SENTINEL, apply_fault_codes,
                                    apply_guard, codec_stage,
                                    make_cohort_round)
from repro_torch.core.runtime import ClientRuntimeModel, DeterministicRuntime
from repro_torch.core.samplers import ClientSampler, UniformSampler
from repro_torch.ingest.pipeline import CohortStager, to_device
from repro_torch.ingest.sources import DataSource, as_data_source
from repro_torch.ingest.stack import stack_batches

# fault kinds with no consumer in the port yet: kind -> what brings it
UNCONSUMED_FAULTS = {
    "ingest_crash": "the supervised staging prefetcher (ROADMAP Queue 1 "
                    "item 11)",
    "ckpt_corrupt": "checkpoints (ROADMAP Queue 1 item 7)",
    "edge_drop": "hierarchical edge folds (ROADMAP Queue 1 item 13)",
}


@dataclass
class AlgoConfig:
    """WHAT to optimize: the server rule + its hyperparameters."""
    name: str = "feddpc"
    eta_l: float = 0.1               # client learning rate
    eta_g: float = 1.0               # server learning rate
    local_optimizer: str = "sgd"
    hyper: Any = None
    # uplink compression (repro_torch/codec): a registry name, None = off;
    # codec_ef feeds the quantization error back (lossy codecs only)
    codec: Optional[str] = None
    codec_ef: bool = False


@dataclass
class ExecConfig:
    """HOW to run it."""
    rounds: int = 50
    clients_per_round: int = 10
    seed: int = 0
    eval_every: int = 5
    vectorize: bool = True           # cohort-vectorized round (default)
    # ---- buffered-async regime (core/async_engine.py) ----
    async_buffer: bool = False
    # arrivals per server step (B); None -> clients_per_round, which at
    # async_concurrency=1 under DeterministicRuntime IS the sync round
    buffer_size: Optional[int] = None
    staleness_alpha: float = 0.5
    # max waves in flight at once: >1 lets fresh waves overlap stale
    # stragglers (staleness > 0 appears), 1 keeps waves serial
    async_concurrency: int = 1
    # execution-level codec overrides: None defers to AlgoConfig
    codec: Optional[str] = None
    codec_ef: Optional[bool] = None
    # ---- chaos hardening (core/guards.py, core/faults.py) ----
    # update guard: quarantine non-finite / exploded-norm client deltas,
    # clip outliers against the rolling median of accepted norms
    guard: bool = False
    guard_quarantine_mult: float = 1e3
    guard_clip_mult: float = 1e2
    guard_window: int = 64
    guard_min_history: int = 8
    # round deadline in VIRTUAL seconds (the runtime model's unit): sync
    # rounds drop and mask clients whose latency exceeds it; the async
    # engine folds a partial buffer. None = wait forever.
    round_deadline: Optional[float] = None


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_accuracy: Optional[float] = None
    seconds: float = 0.0
    diagnostics: Dict[str, float] = field(default_factory=dict)
    # staleness of the arrivals this server step folded (buffered-async
    # only; 0.0 in synchronous rounds)
    staleness_mean: float = 0.0
    staleness_max: float = 0.0
    # uplink bytes this round: clients that shipped x the codec's wire
    # bytes per delta (f32 bytes with no codec)
    comm_bytes_up: int = 0
    quarantined: int = 0           # deltas zeroed and masked by the guard
    clipped: int = 0               # deltas norm-clipped by the guard
    deadline_fired: int = 0        # 1 if the round hit round_deadline
    deadline_dropped: int = 0      # clients dropped by the deadline


def resolve_device(device=None) -> torch.device:
    """None means the card. Asking for CUDA where there is none raises —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class FederatedTrainer:
    """loss_fn(params_tree, batch) -> scalar; eval_fn(params_tree) ->
    accuracy. ``params`` is a parameter tree (numpy or torch leaves),
    copied into the trainer's flat buffer. ``data`` is a DataSource or a
    ``batch_fn(client, round) -> list`` callable. ``runtime`` is the
    client runtime model of the async regime or a round deadline
    (DeterministicRuntime by default); ``fault_plan`` a
    core/faults.FaultPlan. ``device=None`` means "cuda" and raises when
    CUDA is absent."""

    def __init__(self, loss_fn: Callable, params, num_clients: int, data,
                 cfg: Optional[ExecConfig] = None,
                 eval_fn: Optional[Callable] = None, *,
                 algo: Optional[AlgoConfig] = None,
                 sampler: Optional[ClientSampler] = None,
                 runtime: Optional[ClientRuntimeModel] = None,
                 fault_plan=None, device=None):
        self.cfg = cfg if cfg is not None else ExecConfig()
        self.algo_cfg = algo if algo is not None else AlgoConfig()
        deadline = self.cfg.round_deadline
        if (runtime is not None and not self.cfg.async_buffer
                and deadline is None):
            raise ValueError(
                "a runtime model drives the buffered-async regime or a "
                "round deadline — pass ExecConfig(async_buffer=True) or "
                "ExecConfig(round_deadline=...) with it")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"round_deadline must be positive, got "
                             f"{deadline}")
        if fault_plan is not None:
            for kind, needs in UNCONSUMED_FAULTS.items():
                if any(i.kind == kind for i in fault_plan.injectors):
                    raise ValueError(
                        f"fault plan holds a {kind!r} injector, which the "
                        f"port cannot apply yet: it needs {needs}")
        if self.cfg.async_buffer and not self.cfg.vectorize:
            raise ValueError("async_buffer dispatches whole waves through "
                             "the cohort-vectorized update; it cannot "
                             "combine with vectorize=False")
        codec_name = (self.cfg.codec if self.cfg.codec is not None
                      else self.algo_cfg.codec)
        want_ef = (self.cfg.codec_ef if self.cfg.codec_ef is not None
                   else self.algo_cfg.codec_ef)
        self._codec = make_codec(codec_name)
        lossy = self._codec is not None and self._codec.lossy
        if want_ef and not lossy:
            raise ValueError(
                "codec_ef=True needs a LOSSY codec (bf16/int8 family): "
                f"codec={codec_name!r} has no quantization residual to "
                "feed back")
        self._codec_lossy = lossy
        self.device = resolve_device(device)
        # The reference computes in full f32. cuDNN's TF32 default for
        # convolutions would put the card's losses about three digits
        # away from it, so TF32 is off for matmuls and convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.flat, self.layout = bridge.load_params(params, self.device)
        self.num_clients = num_clients
        self.source: DataSource = as_data_source(data)
        self.eval_fn = eval_fn
        self.sampler: ClientSampler = sampler if sampler is not None else \
            UniformSampler(num_clients, self.cfg.clients_per_round)
        self.algo: ServerAlgo = make_algorithm(self.algo_cfg.name,
                                               self.algo_cfg.hyper)
        self.server_state = self.algo.init(self.flat, num_clients)
        # server-side error-feedback accumulator (flat f32)
        self._ef = (torch.zeros_like(self.flat) if lossy and want_ef
                    else None)
        # uplink bytes one client pays per round
        self._client_bytes_up = (
            self._codec.client_bytes(self.layout.numels)
            if self._codec is not None else 4 * self.layout.size)
        # ---- chaos hardening ----
        self.fault_plan = fault_plan
        self._inject_deltas = (fault_plan is not None
                               and fault_plan.injects_deltas)
        self._magnitude = (fault_plan.explode_magnitude
                           if fault_plan is not None else 1e12)
        self._guard = None
        if self.cfg.guard:
            self._guard = UpdateGuard(GuardConfig(
                quarantine_mult=self.cfg.guard_quarantine_mult,
                clip_mult=self.cfg.guard_clip_mult,
                window=self.cfg.guard_window,
                min_history=self.cfg.guard_min_history))
        # sync rounds mask timed-out clients; the async engine instead
        # stops collecting arrivals at the deadline
        self._deadline_mask = (deadline is not None
                               and not self.cfg.async_buffer)
        self._cohort_round = make_cohort_round(
            loss_fn, self.layout, self.algo, self.algo_cfg.eta_l,
            self.algo_cfg.eta_g, optimizer=self.algo_cfg.local_optimizer,
            codec=self._codec, codec_ef=self._ef is not None,
            guard=self._guard is not None,
            guard_cfg=None if self._guard is None else self._guard.config,
            inject_faults=self._inject_deltas,
            deadline_mask=self._deadline_mask,
            fault_magnitude=self._magnitude)
        self.local_update = client_mod.make_local_update(
            loss_fn, self.layout, self.algo_cfg.eta_l,
            optimizer=self.algo_cfg.local_optimizer)
        self.rng = np.random.RandomState(self.cfg.seed)
        self.history: List[RoundRecord] = []
        self.schedule: List[np.ndarray] = []     # sampled cohort per round
        self._stager = CohortStager(self.source, self._sample_clients,
                                    self.device)
        # a round deadline without async_buffer needs latencies too: the
        # runtime model decides who times out
        self._runtime = None
        self._engine = None
        self._wave_runtime: Dict[int, tuple] = {}
        if self.cfg.async_buffer or deadline is not None:
            self._runtime = (runtime if runtime is not None
                             else DeterministicRuntime())
        if self.cfg.async_buffer:
            self._engine = self._build_async_engine(loss_fn)

    @property
    def _max_batches(self) -> Optional[int]:
        """The grow-once M bucket, owned by the stager."""
        return self._stager.max_batches

    @property
    def params(self):
        """The parameter tree: views into the flat buffer."""
        return self.layout.unflatten(self.flat)

    # ---- internals ----

    def _build_async_engine(self, loss_fn):
        """Split the round at the arrival buffer: a WAVE update (local
        training against the dispatch-time snapshot, then the codec's
        encode) and a staleness-weighted FOLD over the buffered deltas.
        The fold decodes first, then applies the chaos extras in the sync
        round's order — fault codes derived per arrival, then the guard.
        A staleness-aware rule (FedDPC) takes the discounts into its own
        scalars; any other rule gets the deltas pre-scaled by them."""
        local = client_mod.make_cohort_local_update(
            loss_fn, self.layout, self.algo_cfg.eta_l,
            optimizer=self.algo_cfg.local_optimizer)
        algo, eta_g = self.algo, self.algo_cfg.eta_g
        codec = self._codec if self._codec_lossy else None
        offsets = self.layout.leaf_offsets
        inject, guard = self._inject_deltas, self._guard is not None

        def wave_update(params, server_state, batches, masks):
            # a fresh stack per wave: the arrival heap keeps rows of it
            # until their fold, past later waves' training
            deltas, losses = local(params, batches, masks)
            if codec is None:
                return deltas, losses
            # entries carry the wire payload; EF advances here, in
            # dispatch order, over the whole wave, as in the reference
            _, payload, resid = codec_stage(codec, deltas, self._ef, offsets)
            if resid is not None:
                self._ef = proj.masked_client_mean(resid)
            return payload, losses

        def fold(server_state, params, deltas, ids, weights, *chaos):
            ids = torch.as_tensor(ids, device=self.device)
            weights = torch.as_tensor(weights, device=self.device)
            encoded = None
            if codec is not None:
                encoded = deltas
                deltas = codec.decode_cohort(encoded, offsets)
            it = iter(chaos)
            cm = gstats = None
            if inject:
                deltas = apply_fault_codes(deltas, next(it), self._magnitude)
                encoded = None       # the payload no longer holds the rows
            if guard:
                deltas, ids, cm, gstats = apply_guard(
                    deltas, ids, cm, next(it), self._guard.config)
                encoded = None
            if algo.staleness_aware:
                out = algo.step(server_state, params, deltas, ids, eta_g, 0,
                                client_mask=cm, staleness_weights=weights,
                                encoded=encoded, leaf_offsets=offsets)
            else:
                out = algo.step(server_state, params,
                                weights[:, None] * deltas, ids, eta_g, 0,
                                client_mask=cm)
            return out + (gstats,) if guard else out

        fold_extras = None
        if inject or guard:
            def fold_extras(entries):
                out = []
                if inject:
                    # per (kind, wave) the draws are prefix-stable in the
                    # client id: per arrival equals the whole-cohort query
                    out.append(torch.as_tensor(np.asarray(
                        [self.fault_plan.delta_codes(
                            e.wave, np.asarray([e.client]))[0]
                         for e in entries], np.int32)))
                if guard:
                    out.append(self._guard.threshold())
                return tuple(out)

        return BufferedAsyncEngine(
            pipeline=self._stager, wave_update=wave_update, fold=fold,
            runtime_take=self._wave_runtime.pop,
            buffer_size=(self.cfg.buffer_size
                         or self.cfg.clients_per_round),
            alpha=self.cfg.staleness_alpha,
            concurrency=self.cfg.async_concurrency,
            deadline=self.cfg.round_deadline, fold_extras=fold_extras,
            fold_returns_stats=guard)

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
        if self._runtime is not None:
            # the runtime draws right after the sampler's, wave by wave:
            # the reference's RNG stream, draw for draw
            lat, dropped = self._runtime.draw(self.rng, t, clients)
            lat = np.asarray(lat, np.float64)
            if self.fault_plan is not None:
                # hangs: stateless, added after the draw, so the RNG
                # stream is the no-faults stream
                lat = lat + self.fault_plan.latency_boost(t, clients)
            self._wave_runtime[t] = (lat, np.asarray(dropped, bool))
        return clients

    def _deadline_live(self, t: int, extra: Dict[str, Any]):
        """(live, shipped) masks of round t's clients under the deadline.
        A late client shipped its update (it pays its uplink) but arrived
        too late for the fold; a runtime dropout shipped nothing."""
        lat, dropped = self._wave_runtime.pop(t)
        live = ~dropped & (lat <= self.cfg.round_deadline)
        extra["deadline_dropped"] = int((~live).sum())
        extra["deadline_fired"] = int((~live).any())
        return live, ~dropped

    def _observe_guard(self, gstats, live: np.ndarray,
                       extra: Dict[str, Any]):
        """Count the round's quarantined and clipped rows among the live
        ones (a row both dropped and bad counts as dropped) and feed the
        accepted norms to the guard's window, in round order."""
        q = gstats["quarantined"].cpu().numpy()
        c = gstats["clipped"].cpu().numpy()
        norms = gstats["norm"].cpu().numpy()
        extra["quarantined"] = int((q & live).sum())
        extra["clipped"] = int((c & live).sum())
        self._guard.observe(norms[live & ~q],
                            quarantined=extra["quarantined"],
                            clipped=extra["clipped"])

    def _run_round_vectorized(self, t: int):
        staged = self._stager.stage_blocking(t)
        n = len(staged.clients)
        args = [self.server_state, self.flat, staged.batches, staged.masks,
                staged.ids]
        extra: Dict[str, Any] = {}
        live = shipped = np.ones(n, bool)
        if self._inject_deltas:
            args.append(torch.as_tensor(
                self.fault_plan.delta_codes(t, staged.clients),
                device=self.device))
        if self._deadline_mask:
            live, shipped = self._deadline_live(t, extra)
            args.append(torch.as_tensor(live, device=self.device))
        if self._guard is not None:
            args.append(self._guard.threshold())
        if self._ef is not None:
            args.append(self._ef)
        outs = list(self._cohort_round(*args))
        if self._ef is not None:
            self._ef = outs.pop()
        gstats = outs.pop() if self._guard is not None else None
        self.flat, self.server_state, losses, diag = outs
        if gstats is not None:
            self._observe_guard(gstats, live, extra)
        extra["comm_bytes_up"] = self._client_bytes_up * int(shipped.sum())
        # the loss over the clients whose update arrived
        losses_h = losses.cpu().numpy()
        return (float(losses_h[live].mean()) if live.any() else 0.0), \
            diag, extra

    def _run_round_serial(self, t: int):
        """One client at a time, then the round's stages on the stacked
        deltas in the reference's serial order: faults, encode and
        decode, deadline mask, guard, error feedback; the server rule
        gets the decoded rows (no payload)."""
        clients = self._sample_clients(t)
        lists = self._stager.client_lists(clients, t)
        n = len(clients)
        deltas = torch.empty((n, self.layout.size), dtype=torch.float32,
                             device=self.device)
        losses = []
        for j, blist in enumerate(lists):
            batches, mask = to_device(
                stack_batches(blist, self._max_batches), self.device)
            _, loss = self.local_update(self.flat, batches, mask,
                                        out=deltas[j])
            losses.append(float(loss))
        ids = torch.as_tensor(clients, dtype=torch.int32, device=self.device)
        extra: Dict[str, Any] = {}
        cm = resid = None
        live = shipped = np.ones(n, bool)
        if self._inject_deltas:
            deltas = apply_fault_codes(
                deltas, torch.as_tensor(self.fault_plan.delta_codes(
                    t, clients)), self._magnitude)
        if self._codec_lossy:
            deltas, _, resid = codec_stage(self._codec, deltas, self._ef,
                                           self.layout.leaf_offsets)
        if self._deadline_mask:
            live, shipped = self._deadline_live(t, extra)
            cm = torch.as_tensor(live, device=self.device)
            ids = torch.where(cm, ids, torch.full_like(ids, ID_SENTINEL))
        if self._guard is not None:
            deltas, ids, cm, gstats = apply_guard(
                deltas, ids, cm, self._guard.threshold(), self._guard.config)
            self._observe_guard(gstats, live, extra)
        if resid is not None:
            self._ef = proj.masked_client_mean(resid, cm)
        self.flat, self.server_state, diag = self.algo.step(
            self.server_state, self.flat, deltas, ids, self.algo_cfg.eta_g,
            0, client_mask=cm)
        extra["comm_bytes_up"] = self._client_bytes_up * int(shipped.sum())
        losses_h = np.asarray(losses)
        return (float(losses_h[live].mean()) if live.any() else 0.0), \
            diag, extra

    def _run_round_async(self, t: int):
        """One buffered-async server step: the engine collects the next
        buffer_size arrivals (dispatching waves as concurrency allows,
        stopping at the round deadline) and folds them with their
        staleness discounts."""
        self.flat, self.server_state, m = self._engine.run_server_round(
            t, self.flat, self.server_state)
        extra = {"staleness_mean": m["staleness_mean"],
                 "staleness_max": m["staleness_max"],
                 # bytes are paid when an update ships, whichever fold
                 # takes it
                 "comm_bytes_up": self._client_bytes_up * int(m["n_shipped"])}
        if self.cfg.round_deadline is not None:
            extra["deadline_fired"] = int(m["deadline_fired"])
            extra["deadline_dropped"] = int(m["deadline_dropped"])
        if m["guard_stats"] is not None:
            self._observe_guard(m["guard_stats"],
                                np.ones(int(m["n_arrivals"]), bool), extra)
        return m["train_loss"], m["diag"], extra

    # ---- public ----

    def evaluate(self) -> float:
        with torch.no_grad():
            return float(self.eval_fn(self.params))

    def run_round(self, t: int) -> RoundRecord:
        tic = time.perf_counter()
        run = (self._run_round_async if self._engine is not None
               else self._run_round_vectorized if self.cfg.vectorize
               else self._run_round_serial)
        train_loss, diag, extra = run(t)   # reads the losses: syncs
        rec = RoundRecord(round=t, train_loss=train_loss,
                          seconds=time.perf_counter() - tic,
                          diagnostics={k: float(v) for k, v in diag.items()},
                          **extra)
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
