"""FederatedTrainer — the simulation-mode FL driver that reproduces the
paper; counterpart of the part of repro/core/api.py the quickstart, the
buffered-async regime, the delta codecs and the chaos layer use.

The trainer drives three pluggable pieces through one loop:

  ClientSampler (core/samplers.py)   WHO participates each round, drawn
      from the trainer's ``np.random.RandomState(seed)`` in round order —
      the same draws as the reference for the same seed;
  DataSource (ingest/sources.py)     WHERE batches come from:
      ``source.client_batches(client, round)``;
  the algorithm registry (core/baselines.py)   HOW updates aggregate:
      the server rule, its client variant (prox/cm/ga, fed Δ_{t-1}
      through ``algo.client_extra``) and, composable with any rule, a
      server optimizer (optim/server.py: fedadam/fedyogi moments over
      the rule's proposed step).

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

Checkpointing: ``save(dir)`` writes the full ``TrainerState`` (params,
server state, RNG + sampler state, round, shape bucket, history, and
the stateful layers: the server optimizer's moments, the error-feedback
accumulator, the guard's window, the runtime model's state, the async
engine's clock and in-flight entries) through checkpoint/checkpoint.py,
in the reference's on-disk format: a checkpoint either package wrote
resumes in the other. ``FederatedTrainer.resume(dir, ...)`` restores it
into a fresh trainer whose continued run reproduces the uninterrupted
one round for round; a corrupt newest step falls back to the newest
intact one. ``ExecConfig.health`` feeds every RoundRecord to the
run-health monitor (repro_torch/health), whose early stop ``run()``
honors.

Staged ingest (ingest/pipeline.py), as the reference's defaults have
it: ``ExecConfig.prefetch`` runs sampling, reads, stacking into a
``prefetch_depth`` ring of pinned host buffers and (``device_stage``) the
non-blocking copy to the card on a producer thread, while the current
round trains; the round's stream waits only on the copy's event. The
producer is supervised (``ingest_max_restarts``; the ``ingest_crash``
fault kind injects its failures). ``async_eval`` runs ``eval_fn`` on a
params snapshot in a worker thread on its own stream; the accuracy lands
in its RoundRecord at the next eval boundary, ``finalize()`` or the end
of ``run()``. The trainer is a context manager: ``close()`` releases the
producer and the eval worker.

Hierarchical edges (``ExecConfig.edges``) fold the padded cohort in E
equal contiguous row groups, as the reference's two-level server fold
does; a ``FaultPlan``'s ``edge_drop`` loses an edge's summary, and its
rows fold out through the same live mask as the round deadline's.

The client axis across processes: in a job joined by
launch/distributed.maybe_initialize(), ``ExecConfig.shard_clients``
makes every rank (one process each, on its own device) hold the
replicated params and server state and train, stage and read only its
contiguous slice of the cohort, padded to the ranks with masked dummy
rows; core/round.py's two collectives a round combine the slices. Rank
0 writes checkpoints and the health log. Without ``shard_clients`` a
trainer in such a job stays process-local, as the reference's does.

The model axis: ``shard_model = M > 1`` (with ``shard_clients``, in a job
whose ranks M divides) lays the ranks out as a (ranks // M, M)
``(clients, model)`` mesh. Each rank holds at rest only its shard of the
params, the server state, the optimizer's moments and the
error-feedback accumulator (sharding/layout.ShardLayout under
sharding/rules.cohort_param_specs): N_m of the N columns. The route of
local training is chosen at construction from the task's model family
(core/round.cohort_local_update): a GQA decoder's LM task, dense or MoE
(transformer.LMLoss) trains tensor-parallel — every model rank trains
every row of the client slice on its shard, so a slice with fewer rows
than M trains too; any other task (the vision models) gathers the params
within the model group, each model rank trains its share of the slice's
rows at full width, and an all-to-all hands every delta's shards to
their owners. The server step then runs on shards (core/round.py).
``full_params``, ``full_state`` and ``params`` gather (every rank calls
them alike); checkpoints hold whole vectors, so
they resume across process counts and in either package.

Buffered-async rounds run across the ranks on either axis: every rank
runs the same engine over the same arrival heap, a wave trains each
rank's rows as a sync round does, and only the client slice that trained
an update holds its delta (core/async_engine.py). A fold is a
core/round.BufferShard over the arrivals the rank holds; a mid-buffer
checkpoint gathers each in-flight entry whole from its slice, and a
restore on any process count hands entry j to client slice j mod the
slices.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.codec import make_codec
from repro_torch.core import client as client_mod
from repro_torch.core.async_engine import BufferEntry, BufferedAsyncEngine
from repro_torch.core.baselines import (ServerAlgo, client_kwargs,
                                        make_algorithm)
from repro_torch.core import jax_prng
from repro_torch.core import projection as proj
from repro_torch.core.guards import GuardConfig, UpdateGuard
from repro_torch.core.round import (ID_SENTINEL, BufferShard, RankShard,
                                    apply_fault_codes, apply_guard,
                                    codec_stage, cohort_local_update,
                                    make_cohort_round, shard_row_scalars)
from repro_torch.core.runtime import ClientRuntimeModel, DeterministicRuntime
from repro_torch.core.samplers import (ClientSampler, UniformSampler,
                                       normalize_sampler_config)
from repro_torch.health.monitor import (HealthConfig, HealthMonitor,
                                        JsonlHealthSink)
from repro_torch.ingest.pipeline import CohortIngestPipeline
from repro_torch.ingest.placement import CohortPlacer, put_global
from repro_torch.ingest.sources import DataSource, as_data_source
from repro_torch.ingest.stack import stack_batches
from repro_torch.launch import distributed
from repro_torch.core.round import model_all_gather
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.optim.server import make_server_optimizer
from repro_torch.sharding.layout import ShardLayout
from repro_torch.sharding.rules import (local_row_range, model_row_split,
                                        padded_rows)

# multi-process trainers of one job, numbered in construction order (the
# same on every rank): their store keys never collide
_MP_SEQ = itertools.count()


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
    # server optimizer (optim/server.py): "sgd" accepts the rule's step
    # verbatim; "fedadam" / "fedyogi" precondition it
    server_opt: str = "sgd"


@dataclass
class ExecConfig:
    """HOW to run it."""
    rounds: int = 50
    clients_per_round: int = 10
    seed: int = 0
    eval_every: int = 5
    vectorize: bool = True           # cohort-vectorized round (default)
    # the cohort over every rank of a multi-process job (each rank trains
    # its contiguous slice); a no-op in a single process
    shard_clients: bool = False
    # model-axis shards per client slice: with shard_clients in a job whose
    # ranks it divides, a (ranks // shard_model, shard_model) mesh
    shard_model: int = 1
    # ---- staged ingest (ingest/pipeline.py) ----
    prefetch: bool = True            # staging ring on a producer thread
    # staging slots: the producer stages up to prefetch_depth rounds past
    # the oldest round still in flight
    prefetch_depth: int = 2
    # issue the copy to the card on the producer thread (a side stream;
    # the round's stream waits on its event); False copies on the
    # consumer thread, measured as RoundRecord.ingest_device_seconds
    device_stage: bool = True
    # eval_fn on a params snapshot in a worker thread, overlapped with the
    # next round: read the accuracy from history, not from the record
    # run_round just returned; False evaluates inline
    async_eval: bool = True
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
    # execution-level server-optimizer override: None defers to AlgoConfig
    server_opt: Optional[str] = None
    # staging-ring stall deadline (seconds): a producer alive but stuck
    # inside a source read raises instead of hanging; None waits forever
    ingest_stall_s: Optional[float] = None
    # supervised restarts of a failed staging producer over the run, with
    # exponential backoff from ingest_restart_backoff_s; 0 fails fast
    ingest_max_restarts: int = 0
    ingest_restart_backoff_s: float = 0.05
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
    # ---- run-health monitor (repro_torch/health) ----
    # consume every RoundRecord through a HealthMonitor: rolling-median
    # loss spike / non-finite detection, staleness + quarantine-rate
    # trend alarms, and (patience set) an early stop run() honors; the
    # detector's state checkpoints through the aux sidecar
    health: bool = False
    health_window: int = 32
    health_min_history: int = 8
    health_spike_mult: float = 3.0
    health_patience: Optional[int] = None
    # stream every verdict to a JSONL tracker file (JsonlHealthSink);
    # None = receipts only
    health_log: Optional[str] = None
    # ---- hierarchical edge aggregation ----
    # two-level server fold: the padded cohort splits into `edges` equal
    # contiguous row groups, each folds its rows into one partial summary
    # and the server combines the E summaries. None / 1 = flat fold. Must
    # divide the padded cohort; synchronous rounds only.
    edges: Optional[int] = None
    # the data source's settings, read by the training CLI when it builds
    # the source (launch/train.py build_vision_task), never by the
    # trainer: the decode pool of path-indexed datasets (0 = serial),
    # batch size and local epochs
    decode_workers: int = 0
    batch_size: int = 256
    local_epochs: int = 1


# Execution regimes of the reference's cross-regime matrix (its
# tests/test_regime_matrix.py): name -> ExecConfig overrides relative to
# the serial reference, the reference's keys and values. The five with
# shard_model > 1 ("*2d") run on a job of shard_model ranks or a multiple
# of it (the port's model axis spans ranks); "multihost" is the
# single-process anchor of the multi-process cohort.
EXEC_REGIMES = {
    "serial": {"vectorize": False},
    "vectorized": {},
    "sharded1d": {"shard_clients": True},
    "sharded2d": {"shard_clients": True, "shard_model": 4},
    "staged": {"prefetch_depth": 4},
    "staged1d": {"shard_clients": True, "prefetch_depth": 4},
    "staged2d": {"shard_clients": True, "shard_model": 4,
                 "prefetch_depth": 4},
    "hoststaged": {"device_stage": False, "prefetch_depth": 1},
    "async_buffer": {"async_buffer": True},
    "guarded": {"guard": True},
    "codec_identity": {"codec": "identity"},
    "codec_bf16": {"codec": "bf16"},
    "codec_int8": {"codec": "int8"},
    "codec_int8_2d": {"codec": "int8", "shard_clients": True,
                      "shard_model": 4},
    "codec_int8_async": {"codec": "int8", "async_buffer": True},
    "server_fedadam": {"server_opt": "fedadam"},
    "server_fedyogi": {"server_opt": "fedyogi"},
    "server_fedadam_2d": {"server_opt": "fedadam", "shard_clients": True,
                          "shard_model": 4},
    "server_fedyogi_2d": {"server_opt": "fedyogi", "shard_clients": True,
                          "shard_model": 4},
    "server_fedadam_async": {"server_opt": "fedadam", "async_buffer": True},
    "server_fedyogi_async": {"server_opt": "fedyogi", "async_buffer": True},
    "multihost": {"shard_clients": True, "edges": 2},
}


@dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_accuracy: Optional[float] = None
    seconds: float = 0.0
    # time this round spent blocked on cohort ingest: host + device
    ingest_seconds: float = 0.0
    # blocked on host staging (sample, read, stack; with prefetch on, the
    # wait for the staged round)
    ingest_host_seconds: float = 0.0
    # blocked on the copy to the device at dispatch (host-staged and
    # blocking placement); 0 when the producer thread issues it
    ingest_device_seconds: float = 0.0
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
    ingest_restarts: int = 0       # staging-producer restarts this round
    # the uplink split by round shape: client->edge bytes (the clients'
    # deltas) and edge->server bytes (one raw-f32 summary per LIVE edge).
    # A flat round reports edge_up = 0 and server_up = comm_bytes_up
    comm_bytes_edge_up: int = 0
    comm_bytes_server_up: int = 0
    edge_dropped: int = 0          # edge summaries lost (edge_drop faults)


@dataclass
class TrainerState:
    """Everything needed to continue a run exactly where it stopped:
    the checkpoint unit of ``FederatedTrainer.save()/resume()``.

    ``round`` is the NEXT round to run; ``rng_state`` / ``sampler_state``
    are the values they held BEFORE that round's cohort was sampled (the
    async engine dispatches waves ahead of server rounds, so the trainer
    snapshots them at sampling time and rolls back to the wave frontier).
    ``params`` is the parameter tree and ``server_state`` / ``opt_state``
    the port's flat state dicts."""
    params: Any
    server_state: Any
    round: int
    max_batches: Optional[int]
    rng_state: tuple                     # np.random.RandomState.get_state()
    sampler_state: Dict
    schedule: List[np.ndarray]
    history: List[RoundRecord]
    # runtime-model state (e.g. the Markov fast/slow chain) as of the
    # next wave to dispatch; None without a runtime model
    runtime_state: Optional[Dict] = None
    # server-optimizer moments {"m", "v"}; None for the stateless sgd
    opt_state: Optional[Any] = None


# hyper fields of the reference that pick the kernel route, which the
# port's device decides: written as the reference's default, not compared
_ROUTE_FIELDS = {"FedDPCHyper": {"use_kernel": False}}


def _without_route(echo: Optional[dict]) -> Optional[dict]:
    if not echo or "hyper" not in echo:
        return echo
    hyper = {k: v for k, v in echo["hyper"].items()
             if k not in _ROUTE_FIELDS.get(echo["hyper"].get("class"), {})}
    return {**echo, "hyper": hyper}


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
    core/faults.FaultPlan; ``health_sink`` a tracker with the wandb-style
    ``log(data, step)`` for the health monitor's verdicts.
    ``device=None`` means "cuda" and raises when CUDA is absent."""

    def __init__(self, loss_fn: Callable, params, num_clients: int, data,
                 cfg: Optional[ExecConfig] = None,
                 eval_fn: Optional[Callable] = None, *,
                 algo: Optional[AlgoConfig] = None,
                 sampler: Optional[ClientSampler] = None,
                 runtime: Optional[ClientRuntimeModel] = None,
                 fault_plan=None, health_sink=None, device=None):
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
        # ---- the client axis across processes ----
        # maybe_initialize() has joined the job before construction, so
        # the process count is final here. shard_clients is the switch:
        # with it the cohort spans every rank; without it the trainer
        # stays process-local (no cross-process traffic)
        self._mp = (distributed.process_count() > 1
                    and self.cfg.shard_clients)
        self._mp_seq = next(_MP_SEQ) if self._mp else 0
        self._save_seq = 0
        if self._mp and not self.cfg.vectorize:
            raise ValueError(
                "multi-process execution drives the fused cohort round; it "
                "cannot combine with vectorize=False")
        model = int(self.cfg.shard_model)
        if model > 1 and not (self._mp and distributed.process_count()
                              % model == 0):
            raise ValueError(
                f"shard_model={model} needs shard_clients=True in a "
                "multi-process job whose ranks it divides: the port's model "
                "axis spans ranks, one process a device "
                f"(this process: {distributed.process_count()} ranks, "
                f"shard_clients={self.cfg.shard_clients})")
        if want_ef and not lossy:
            raise ValueError(
                "codec_ef=True needs a LOSSY codec (bf16/int8 family): "
                f"codec={codec_name!r} has no quantization residual to "
                "feed back")
        self._codec_lossy = lossy
        # the wire codes' dtype: bf16's, else the int8 family's
        self._codec_dtype = (torch.bfloat16 if codec_name == "bf16"
                             else torch.int8)
        # int8_sr's noise: the round's key is fold_in(key, round) (the
        # async wave frontier for a wave), as the reference draws it
        self._codec_key = (jax_prng.PRNGKey(self.cfg.seed)
                           if lossy and self._codec.stochastic else None)
        self.device = resolve_device(device)
        # The reference computes in full f32. cuDNN's TF32 default for
        # convolutions would put the card's losses about three digits
        # away from it, so TF32 is off for matmuls and convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.flat, self.layout = bridge.load_params(params, self.device)
        # ---- the model axis: params and state at rest are shards ----
        self.mesh = (make_cohort_mesh(model=model) if self._mp else None)
        self._shards: Optional[ShardLayout] = None
        self._model_group = None
        self._m = 0
        if model > 1:
            self._shards = ShardLayout.from_mesh(self.layout, self.mesh)
            self._model_group = self.mesh["model"].get_group()
            self._m = distributed.process_index() % model
            self.flat = self._shards.scatter(self.flat, self._m)
        # where each leaf the rank holds starts in its vector
        self._offsets = (self.layout.leaf_offsets if self._shards is None
                         else self._shards.offsets(self._m))
        self.num_clients = num_clients
        self.source: DataSource = as_data_source(data)
        self.eval_fn = eval_fn
        self.sampler: ClientSampler = sampler if sampler is not None else \
            UniformSampler(num_clients, self.cfg.clients_per_round)
        self.algo: ServerAlgo = make_algorithm(self.algo_cfg.name,
                                               self.algo_cfg.hyper)
        self.server_state = self.algo.init(self.flat, num_clients)
        # None for sgd: the pass-through stays out of the round
        self._server_opt = make_server_optimizer(
            self.cfg.server_opt if self.cfg.server_opt is not None
            else self.algo_cfg.server_opt)
        self._opt_state = (self._server_opt.init(self.flat)
                           if self._server_opt is not None else None)
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
        # ---- run-health monitor ----
        self._health = None
        if ((self.cfg.health_log or health_sink is not None)
                and not self.cfg.health):
            raise ValueError(
                "health_log / health_sink stream the run-health "
                "monitor's verdicts — set ExecConfig(health=True) too")
        if self.cfg.health_log and health_sink is not None:
            raise ValueError("pass either ExecConfig.health_log or "
                             "health_sink=..., not both")
        if self.cfg.health:
            sink = health_sink
            # one log a run: rank 0's (every rank observes the same
            # records)
            if (sink is None and self.cfg.health_log
                    and distributed.is_coordinator()):
                sink = JsonlHealthSink(self.cfg.health_log)
            self._health = HealthMonitor(HealthConfig(
                window=self.cfg.health_window,
                min_history=self.cfg.health_min_history,
                spike_mult=self.cfg.health_spike_mult,
                patience=self.cfg.health_patience,
                clients_per_round=self.cfg.clients_per_round), sink=sink)
        # sync rounds mask timed-out clients; the async engine instead
        # stops collecting arrivals at the deadline
        self._deadline_mask = (deadline is not None
                               and not self.cfg.async_buffer)
        # the cohort pads to a multiple of the client axis with masked
        # dummy rows; client slice c holds rows [lo, hi) of it, and on the
        # model axis model rank m trains its share of them
        world = (distributed.process_count() // model if self._mp else 1)
        k = self.cfg.clients_per_round
        self._pad_to = padded_rows(k, world)
        self._slice_rows = local_row_range(
            distributed.process_index() // model if self._mp else 0, world,
            self._pad_to)
        # ---- hierarchical edge aggregation ----
        self._edges = (int(self.cfg.edges)
                       if (self.cfg.edges or 0) > 1 else None)
        if self._edges is not None:
            if self.cfg.async_buffer:
                raise ValueError(
                    "edges reshapes the synchronous server fold; it cannot "
                    "combine with async_buffer")
            if self._pad_to % self._edges:
                raise ValueError(
                    f"edges={self._edges} must divide the padded cohort "
                    f"size {self._pad_to} (clients_per_round={k} padded "
                    "to the client axis)")
        # one edge's summary on the edge->server uplink: raw f32 params
        self._summary_bytes_up = 4 * self.layout.size
        # a lost edge's rows fold out through the live-mask input the
        # deadline uses; a plan with edge drops and no edges changes
        # nothing, as in the reference
        self._edge_faults = (fault_plan is not None
                             and fault_plan.injects_edges
                             and self._edges is not None)
        self._live_mask_input = self._deadline_mask or self._edge_faults
        # [(collective, ms)] of each multi-process round, in round order
        self.collective_log: List[List[tuple]] = []
        # the RankShards of an async round's waves and the BufferShard of
        # its fold, whose collectives make its collective_log entry
        self._async_shards: List[Any] = []
        self._cohort_round = make_cohort_round(
            loss_fn, self.layout, self.algo, self.algo_cfg.eta_l,
            self.algo_cfg.eta_g, optimizer=self.algo_cfg.local_optimizer,
            codec=self._codec, codec_ef=self._ef is not None,
            guard=self._guard is not None,
            guard_cfg=None if self._guard is None else self._guard.config,
            inject_faults=self._inject_deltas,
            deadline_mask=self._live_mask_input,
            fault_magnitude=self._magnitude, server_opt=self._server_opt,
            edges=self._edges, group=self._client_group(),
            model_group=self._model_group, shards=self._shards,
            real_clients=k if self._pad_to > k else None)
        # the route of local training on the model axis, chosen once by
        # the round (core/round.cohort_local_update): tensor-parallel
        # trains the whole slice on every model rank, the row split its
        # share at full width
        self._tensor_parallel = self._cohort_round.tp is not None
        self._rows = (self._slice_rows if self._tensor_parallel else
                      model_row_split(*self._slice_rows, model)[self._m])
        self.local_update = client_mod.make_local_update(
            loss_fn, self.layout, self.algo_cfg.eta_l,
            optimizer=self.algo_cfg.local_optimizer,
            variant=self.algo.client_variant, **client_kwargs(self.algo))
        self.rng = np.random.RandomState(self.cfg.seed)
        self.history: List[RoundRecord] = []
        self.schedule: List[np.ndarray] = []     # sampled cohort per round
        # the staged ingest path; the async engine dispatches a dynamic
        # number of waves, so its horizon is open (the ring backpressures
        # on its depth). A rank reads, stacks and copies only its rows;
        # the ranks agree on the minibatch bucket through the job's store
        # (from the producer thread: never a collective there)
        local_rows = sync_mb = None
        if self._mp:
            local_rows, seq = self._rows, self._mp_seq
            sync_mb = (lambda tag, m:
                       distributed.kv_allmax(f"t{seq}/maxb/{tag}", m))
        self._pipeline = CohortIngestPipeline(
            self.source, self._sample_clients, num_clients=num_clients,
            rounds=None if self.cfg.async_buffer else self.cfg.rounds,
            placer=CohortPlacer(self.device, local_rows=local_rows),
            pad_to=self._pad_to if self._mp else None,
            local_rows=local_rows, sync_max_batches=sync_mb,
            depth=self.cfg.prefetch_depth,
            device_stage=self.cfg.device_stage,
            stall_timeout=self.cfg.ingest_stall_s,
            max_restarts=self.cfg.ingest_max_restarts,
            restart_backoff=self.cfg.ingest_restart_backoff_s,
            crash_hook=(fault_plan.ingest_crash
                        if fault_plan is not None else None))
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
        self._start_round = 0                    # advanced by restore()
        # sampling-time snapshots for save(): the producer thread samples
        # rounds (and async waves) ahead of the consumed ones, so each
        # round's pre-draw state is captured when it is sampled, under
        # this lock (see state())
        self._sample_lock = threading.Lock()
        self._round_caps: Dict[int, dict] = {}
        # async eval: one worker thread (and, on the card, its stream);
        # (RoundRecord, Future) of the eval in flight
        self._async_eval = eval_fn is not None and self.cfg.async_eval
        self._eval_pool: Optional[ThreadPoolExecutor] = None
        self._eval_stream = None
        self._pending_eval = None

    @property
    def _max_batches(self) -> Optional[int]:
        """The grow-once M bucket, owned by the ingest pipeline."""
        return self._pipeline.max_batches

    @property
    def params(self):
        """The parameter tree: views into the flat buffer (on the model
        axis, into the gathered full vector: a collective, which every
        rank of the job calls alike)."""
        return self.layout.unflatten(self.full_params())

    def _client_group(self):
        """The client axis's process group of a multi-process trainer."""
        if not self._mp:
            return None
        if self._shards is None:
            return self.mesh.get_group()
        return self.mesh["clients"].get_group()

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N_m) shard -> the (..., N) tensor, over the model ranks;
        ``x`` itself without the model axis."""
        if self._shards is None:
            return x
        return model_all_gather(x, self._model_group, self._shards)

    def full_params(self) -> torch.Tensor:
        """The (N,) parameter vector; on the model axis gathered from the
        shards (every rank of the job calls it alike)."""
        return self._gather(self.flat)

    def full_state(self):
        """The server state with every params-shaped vector whole: a
        shard's (..., N_m) vectors gathered on the model axis; scalars as
        they are."""
        return self._gather_state(self.server_state)

    def _gather_state(self, state):
        if state is None:
            return None
        return {k: v if v.dim() == 0 else self._gather(v)
                for k, v in state.items()}

    def shard_info(self) -> dict:
        """This rank's place on the mesh and what it holds at rest:
        coordinates, the client slice's and trained rows, N_m against
        N, and the bytes of the params, server state, optimizer moments,
        error feedback and the async entries in flight whose deltas it
        holds (a sync round's delta stacks are allocated per round)."""
        nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()
        model = self._shards.model if self._shards is not None else 1
        inflight = 0
        if self._engine is not None:
            for e in self._engine.inflight():
                if e.delta is not None:
                    inflight += sum(nbytes(t) for t in
                                    bridge.tree_leaves(e.delta))
        return {
            "mesh": (None if self.mesh is None else
                     [int(d) for d in self.mesh.mesh.shape]),
            "coords": ([distributed.process_index() // model, self._m]
                       if self._mp else [0, 0]),
            "route": ("tensor_parallel" if self._tensor_parallel else
                      "rows" if self._shards is not None else None),
            "slice_rows": list(self._slice_rows), "train_rows":
            list(self._rows), "N": self.layout.size,
            "N_m": int(self.flat.numel()),
            "bytes": {"params": nbytes(self.flat),
                      "server_state": {k: nbytes(v) for k, v in
                                       self.server_state.items()},
                      "opt_state": sum(nbytes(v) for v in
                                       (self._opt_state or {}).values()),
                      "ef": nbytes(self._ef), "inflight": inflight}}

    # ---- internals ----

    def _build_async_engine(self, loss_fn):
        """Split the round at the arrival buffer: a WAVE update (local
        training against the dispatch-time snapshot, then the codec's
        encode) and a staleness-weighted FOLD over the buffered deltas.
        The fold decodes first, then applies the chaos extras in the sync
        round's order — fault codes derived per arrival, then the guard.
        A staleness-aware rule (the FedDPC family) takes the discounts into
        its own scalars; any other rule gets the deltas pre-scaled by them.
        A wave's clients get ``algo.client_extra`` of the dispatch-time
        server state; a server optimizer re-steps each fold's proposal.

        Across ranks (``shard_clients`` in a job) a wave is this rank's
        part of the padded cohort, as a sync round's (core/round.RankShard:
        the model group's params gathered, the rank's rows trained at full
        width, the all-to-all, the codec's whole-leaf extrema and
        whole-stack noise), its losses summed over the job (one
        collective a wave) and error feedback averaged over the wave's
        real rows. A fold is a core/round.BufferShard over the arrivals
        the rank's client slice holds."""
        local, tp = cohort_local_update(
            loss_fn, self.layout, self.algo, self.algo_cfg.eta_l,
            self.algo_cfg.local_optimizer, self._model_group, self._shards)
        algo, eta_g = self.algo, self.algo_cfg.eta_g
        sopt = self._server_opt
        codec = self._codec if self._codec_lossy else None
        offsets = self._offsets
        inject, guard = self._inject_deltas, self._guard is not None
        guard_cfg = None if self._guard is None else self._guard.config
        ranks = self._mp
        k, kp = self.cfg.clients_per_round, self._pad_to
        # the wave's real rows: the error-feedback mean leaves the padded
        # ones out, as the reference's does
        real = (None if kp == k else
                torch.arange(kp, device=self.device) < k)
        shard_kw = {"model_group": self._model_group,
                    "shards": self._shards}

        def wave_update(params, server_state, batches, masks):
            # a fresh stack per wave: the arrival heap keeps rows of it
            # until their fold, past later waves' training
            extra = algo.client_extra(server_state)
            shard = None
            if not ranks:
                deltas, losses = local(params, batches, masks, extra)
            else:
                shard = RankShard(self._client_group(), kp, tp=tp,
                                  **shard_kw)
                self._async_shards.append(shard)
                deltas, part = shard.local_training(local, params, batches,
                                                    masks, extra)
                losses = torch.zeros(kp, dtype=part.dtype,
                                     device=part.device)
                losses[shard.lo:shard.hi] = part
                losses = shard.job_sum(losses, "wave_losses")
            if codec is None:
                return deltas, losses
            # entries carry the wire payload; EF advances here, in
            # dispatch order, over the whole wave, as in the reference
            key = (None if self._codec_key is None else jax_prng.fold_in(
                self._codec_key, self._engine.wave_frontier))
            _, payload, resid = codec_stage(codec, deltas, self._ef, offsets,
                                            key, shard)
            if resid is not None:
                self._ef = proj.masked_client_mean(resid, real, shard=shard)
            return payload, losses

        def fold(server_state, params, deltas, ids, weights, *chaos,
                 held=None):
            ids = torch.as_tensor(ids, device=self.device)
            weights = torch.as_tensor(weights, device=self.device)
            shard = None
            if held is not None:
                shard = BufferShard(self._client_group(), len(ids), held,
                                    device=self.device, **shard_kw)
                self._async_shards.append(shard)
            encoded = None
            if deltas is None:
                # this rank holds none of the fold's arrivals
                deltas = torch.zeros((0, self.flat.numel()),
                                     dtype=torch.float32, device=self.device)
            elif codec is not None:
                encoded = deltas
                deltas = codec.decode_cohort(encoded, offsets)
            it = iter(chaos)
            cm = gstats = None
            if inject:
                codes = next(it)
                if shard is not None:
                    codes = shard.local_rows(codes)
                deltas = apply_fault_codes(deltas, codes, self._magnitude)
                encoded = None       # the payload no longer holds the rows
            if shard is not None:
                deltas, ids, cm, _, gstats = shard_row_scalars(
                    shard, algo, server_state, deltas, ids, cm,
                    next(it) if guard else None, guard_cfg,
                    row_weights=None if algo.staleness_aware else weights)
            elif guard:
                deltas, ids, cm, gstats = apply_guard(
                    deltas, ids, cm, next(it), guard_cfg)
            if guard:
                encoded = None
            if algo.staleness_aware:
                out = algo.step(server_state, params, deltas, ids, eta_g, 0,
                                client_mask=cm, staleness_weights=weights,
                                encoded=encoded, leaf_offsets=offsets,
                                shard=shard)
            else:
                w = weights if shard is None else shard.local_rows(weights)
                out = algo.step(server_state, params, w[:, None] * deltas,
                                ids, eta_g, 0, client_mask=cm, shard=shard)
            if sopt is not None:
                # the optimizer advances at folds only (server rounds)
                new_p, self._opt_state = sopt.apply(params, out[0],
                                                    self._opt_state)
                out = (new_p,) + tuple(out[1:])
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
            pipeline=self._pipeline, wave_update=wave_update, fold=fold,
            runtime_take=self._runtime_take, prefetch=self.cfg.prefetch,
            buffer_size=(self.cfg.buffer_size
                         or self.cfg.clients_per_round),
            alpha=self.cfg.staleness_alpha,
            concurrency=self.cfg.async_concurrency,
            deadline=self.cfg.round_deadline, fold_extras=fold_extras,
            fold_returns_stats=guard,
            held_rows=self._slice_rows if ranks else None)

    def _capture(self) -> dict:
        """The state a round's sampling starts from: RNG, sampler, shape
        bucket and runtime model."""
        return {"rng": self.rng.get_state(),
                "sampler": self.sampler.state_dict(),
                "max_batches": self._max_batches,
                **({"runtime": self._runtime.state_dict()}
                   if self._runtime is not None else {})}

    def _runtime_take(self, wave: int):
        """The (latencies, dropped) pair drawn for this wave at sampling
        time (on the producer thread, under the sampling lock)."""
        with self._sample_lock:
            return self._wave_runtime.pop(wave)

    def _sample_clients(self, t: int) -> np.ndarray:
        with self._sample_lock:
            self._round_caps[t] = self._capture()
            # keep the captures of the staging look-ahead: the producer
            # samples up to prefetch_depth rounds past the consumed frontier,
            # and state() needs the next unconsumed round's
            horizon = t - (self.cfg.prefetch_depth + 2)
            for old in [r for r in self._round_caps if r < horizon]:
                del self._round_caps[old]
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

    def _live_rows(self, t: int, n: int, kp: int, extra: Dict[str, Any]):
        """(lv (kp,), live (n,), shipped (n,), edges down) of round t's
        n clients padded to kp rows. Under the deadline a late client
        shipped its update (it pays its uplink) but arrived too late for
        the fold, and a runtime dropout shipped nothing. A dropped edge
        loses its summary: every row of it folds out, though its clients
        still shipped to it. Padded rows are never live."""
        lv = np.zeros(kp, bool)
        lv[:n] = True
        live = shipped = np.ones(n, bool)
        if self._deadline_mask:
            lat, dropped = self._runtime_take(t)
            live = ~dropped & (lat <= self.cfg.round_deadline)
            shipped = ~dropped
            lv[:n] = live
            extra["deadline_dropped"] = int((~live).sum())
            extra["deadline_fired"] = int((~live).any())
        edge_down = 0
        if self._edge_faults:
            edrop = self.fault_plan.edge_drops(t, self._edges)
            edge_live = np.repeat(~edrop, kp // self._edges)
            lv &= edge_live
            live = live & edge_live[:n]
            edge_down = int(edrop.sum())
            extra["edge_dropped"] = edge_down
        return lv, live, shipped, edge_down

    def _comm_fields(self, shipped: int, edge_down: int = 0
                     ) -> Dict[str, int]:
        """The uplink by round shape: a flat round pays everything on the
        server uplink; a hierarchical one pays the clients' deltas to the
        edges and one raw-f32 summary per live edge to the server."""
        up = self._client_bytes_up * int(shipped)
        if self._edges is None:
            return {"comm_bytes_up": up, "comm_bytes_edge_up": 0,
                    "comm_bytes_server_up": up}
        return {"comm_bytes_up": up, "comm_bytes_edge_up": up,
                "comm_bytes_server_up": ((self._edges - edge_down)
                                         * self._summary_bytes_up)}

    def _observe_guard(self, gstats, live: np.ndarray,
                       extra: Dict[str, Any]):
        """Count the round's quarantined and clipped rows among the live
        ones (a row both dropped and bad counts as dropped) and feed the
        accepted norms to the guard's window, in round order."""
        n = len(live)
        q = gstats["quarantined"].cpu().numpy()[:n]
        c = gstats["clipped"].cpu().numpy()[:n]
        norms = gstats["norm"].cpu().numpy()[:n]
        extra["quarantined"] = int((q & live).sum())
        extra["clipped"] = int((c & live).sum())
        self._guard.observe(norms[live & ~q],
                            quarantined=extra["quarantined"],
                            clipped=extra["clipped"])

    def _run_round_vectorized(self, t: int):
        staged = (self._pipeline.get(t) if self.cfg.prefetch
                  else self._pipeline.stage_blocking(t))
        try:
            staged.wait()
            n = len(staged.clients)
            kp = self._pad_to
            ids = staged.ids
            if self._mp:
                # the rules see the whole padded cohort's ids; the dummy
                # rows' id is num_clients (out of range), as the
                # reference's
                ids = put_global(np.concatenate(
                    [staged.clients, np.full(kp - n, self.num_clients)]
                ).astype(np.int32), self.device)
            args = [self.server_state, self.flat, staged.batches,
                    staged.masks, ids]
            extra: Dict[str, Any] = {}
            live = shipped = np.ones(n, bool)
            edge_down = 0
            if self._inject_deltas:
                codes = np.zeros(kp, np.int32)
                codes[:n] = self.fault_plan.delta_codes(t, staged.clients)
                args.append(put_global(codes, self.device))
            if self._live_mask_input:
                lv, live, shipped, edge_down = self._live_rows(t, n, kp,
                                                               extra)
                args.append(put_global(lv, self.device))
            if self._guard is not None:
                args.append(self._guard.threshold())
            if self._codec_key is not None:
                args.append(jax_prng.fold_in(self._codec_key, t))
            if self._ef is not None:
                args.append(self._ef)
            if self._server_opt is not None:
                args.append(self._opt_state)
            outs = list(self._cohort_round(*args))
            if self._server_opt is not None:
                self._opt_state = outs.pop()
            if self._ef is not None:
                self._ef = outs.pop()
            gstats = outs.pop() if self._guard is not None else None
            self.flat, self.server_state, losses, diag = outs
            if gstats is not None:
                self._observe_guard(gstats, live, extra)
            extra.update(self._comm_fields(int(shipped.sum()), edge_down))
            # the loss over the clients whose update arrived; the host
            # read waits for the round, after which the slot is free
            losses_h = losses.cpu().numpy()[:n]
            loss = float(losses_h[live].mean()) if live.any() else 0.0
            shard = self._cohort_round.shard
            if shard is not None:
                self.collective_log.append(shard.timings_ms())
        finally:
            # on error too: a leaked slot would deadlock the next round
            staged.release()
        return loss, diag, staged.host_seconds, staged.device_seconds, extra

    def _run_round_serial(self, t: int):
        """One client at a time, then the round's stages on the stacked
        deltas in the reference's serial order: faults, encode and
        decode, deadline mask, guard, error feedback; the server rule
        gets the decoded rows (no payload), then the server optimizer
        re-steps its proposal."""
        clients = self._sample_clients(t)
        tic = time.perf_counter()
        lists = self._pipeline.client_lists(clients, t)
        ingest = time.perf_counter() - tic
        n = len(clients)
        client_extra = self.algo.client_extra(self.server_state)
        deltas = torch.empty((n, self.layout.size), dtype=torch.float32,
                             device=self.device)
        losses = []
        for j, blist in enumerate(lists):
            batches, mask = bridge.tree_map(
                lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(
                    self.device), stack_batches(blist, self._max_batches))
            _, loss = self.local_update(self.flat, batches, mask,
                                        client_extra, out=deltas[j])
            losses.append(float(loss))
        ids = torch.as_tensor(clients, dtype=torch.int32, device=self.device)
        extra: Dict[str, Any] = {}
        cm = resid = None
        live = shipped = np.ones(n, bool)
        edge_down = 0
        if self._inject_deltas:
            deltas = apply_fault_codes(
                deltas, torch.as_tensor(self.fault_plan.delta_codes(
                    t, clients)), self._magnitude)
        if self._codec_lossy:
            key = (None if self._codec_key is None
                   else jax_prng.fold_in(self._codec_key, t))
            deltas, _, resid = codec_stage(self._codec, deltas, self._ef,
                                           self.layout.leaf_offsets, key)
        if self._live_mask_input:
            lv, live, shipped, edge_down = self._live_rows(t, n, n, extra)
            cm = torch.as_tensor(lv, device=self.device)
            ids = torch.where(cm, ids, torch.full_like(ids, ID_SENTINEL))
        if self._guard is not None:
            deltas, ids, cm, gstats = apply_guard(
                deltas, ids, cm, self._guard.threshold(), self._guard.config)
            self._observe_guard(gstats, live, extra)
        if resid is not None:
            self._ef = proj.masked_client_mean(resid, cm)
        new_flat, self.server_state, diag = self.algo.step(
            self.server_state, self.flat, deltas, ids, self.algo_cfg.eta_g,
            0, client_mask=cm, edges=self._edges)
        if self._server_opt is not None:
            new_flat, self._opt_state = self._server_opt.apply(
                self.flat, new_flat, self._opt_state)
        self.flat = new_flat
        extra.update(self._comm_fields(int(shipped.sum()), edge_down))
        losses_h = np.asarray(losses)
        return (float(losses_h[live].mean()) if live.any() else 0.0), \
            diag, ingest, 0.0, extra

    def _run_round_async(self, t: int):
        """One buffered-async server step: the engine collects the next
        buffer_size arrivals (dispatching waves as concurrency allows,
        stopping at the round deadline) and folds them with their
        staleness discounts."""
        self._async_shards = []
        self.flat, self.server_state, m = self._engine.run_server_round(
            t, self.flat, self.server_state)
        if self._mp:
            self.collective_log.append(
                [x for shard in self._async_shards
                 for x in shard.timings_ms()])
        extra = {"staleness_mean": m["staleness_mean"],
                 "staleness_max": m["staleness_max"],
                 # bytes are paid when an update ships, whichever fold
                 # takes it (async rounds are flat: edges refuse them)
                 **self._comm_fields(int(m["n_shipped"]))}
        # restarts charged to the waves staged during this round's
        # collection (keyed by the staged wave, final once handed out)
        restarts = sum(self._pipeline.restarts_for(w)
                       for w in range(m["wave_start"], m["wave_end"]))
        if restarts:
            extra["ingest_restarts"] = restarts
        if self.cfg.round_deadline is not None:
            extra["deadline_fired"] = int(m["deadline_fired"])
            extra["deadline_dropped"] = int(m["deadline_dropped"])
        if m["guard_stats"] is not None:
            self._observe_guard(m["guard_stats"],
                                np.ones(int(m["n_arrivals"]), bool), extra)
        return (m["train_loss"], m["diag"], m["host_seconds"],
                m["device_seconds"], extra)

    def _eval_async(self, rec: RoundRecord):
        """Evaluate a snapshot of the params in the worker thread: the
        clone is taken on the round's stream and an event recorded after
        it; the worker's stream waits on the event. The accuracy lands in
        ``rec`` when the future is resolved."""
        snap = self.full_params().clone()
        event = stream = None
        if snap.is_cuda:
            if self._eval_stream is None:
                self._eval_stream = torch.cuda.Stream(device=snap.device)
            stream = self._eval_stream
            event = torch.cuda.Event()
            event.record()
            snap.record_stream(stream)
        if self._eval_pool is None:
            self._eval_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fl-eval")

        def run(fn=self.eval_fn, layout=self.layout):
            if stream is None:
                with torch.no_grad():
                    return float(fn(layout.unflatten(snap)))
            with torch.cuda.device(snap.device), torch.cuda.stream(stream), \
                    torch.no_grad():
                stream.wait_event(event)
                return float(fn(layout.unflatten(snap)))
        self._pending_eval = (rec, self._eval_pool.submit(run))

    def _resolve_pending_eval(self):
        """Land the eval in flight in its record; a failed eval raises
        here."""
        if self._pending_eval is not None:
            rec, fut = self._pending_eval
            self._pending_eval = None
            rec.test_accuracy = fut.result()

    # ---- public ----

    def evaluate(self) -> float:
        with torch.no_grad():
            return float(self.eval_fn(self.params))

    def run_round(self, t: int) -> RoundRecord:
        # a finished async eval lands without blocking (and its error
        # surfaces here)
        if self._pending_eval is not None and self._pending_eval[1].done():
            self._resolve_pending_eval()
        tic = time.perf_counter()
        run = (self._run_round_async if self._engine is not None
               else self._run_round_vectorized if self.cfg.vectorize
               else self._run_round_serial)
        train_loss, diag, ingest_host, ingest_dev, extra = run(t)
        if self._engine is None:
            # restarts charged to the round whose STAGING failed (the
            # producer stages ahead); the async engine charges waves
            restarts = self._pipeline.restarts_for(t)
            if restarts:
                extra["ingest_restarts"] = restarts
        rec = RoundRecord(round=t, train_loss=train_loss,
                          seconds=time.perf_counter() - tic,
                          ingest_seconds=ingest_host + ingest_dev,
                          ingest_host_seconds=ingest_host,
                          ingest_device_seconds=ingest_dev,
                          diagnostics={k: float(v) for k, v in diag.items()},
                          **extra)
        if self.eval_fn and (t % self.cfg.eval_every == 0
                             or t == self.cfg.rounds - 1):
            # the previous eval lands before its boundary passes
            self._resolve_pending_eval()
            if self._async_eval:
                self._eval_async(rec)
            else:
                rec.test_accuracy = self.evaluate()
        self.history.append(rec)
        if self._health is not None:
            # consumes the record in round order; read the verdict from
            # health_report (run() honors should_stop)
            self._health.observe(rec)
        return rec

    def finalize(self):
        """Land the eval in flight into its RoundRecord."""
        self._resolve_pending_eval()

    def close(self):
        """Release trainer-owned resources: the staging thread, the eval
        worker (its result lands first; its error raises after the rest
        is released) and the health sink's file. The data source is the
        caller's and is never closed here."""
        try:
            self.finalize()
        finally:
            self._pipeline.close()
            if self._eval_pool is not None:
                self._eval_pool.shutdown(wait=True)
                self._eval_pool = None
            if self._health is not None:
                self._health.close_sink()

    def __enter__(self) -> "FederatedTrainer":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def run(self, verbose: bool = False) -> List[RoundRecord]:
        for t in range(self._start_round, self.cfg.rounds):
            rec = self.run_round(t)
            if (self._health is not None
                    and self._health.last_report is not None
                    and self._health.last_report.should_stop):
                # the detector asked for an early stop; the report
                # (health_report) says why
                if verbose:
                    print(f"[{self.algo.name}] round {t:4d} health stop: "
                          f"{self._health.last_report.alarms}")
                break
            if verbose:
                # someone is watching: land this round's eval now, so the
                # accuracy prints with its round
                self._resolve_pending_eval()
                acc = ("" if rec.test_accuracy is None
                       else f"  acc={rec.test_accuracy:.4f}")
                print(f"[{self.algo.name}] round {t:4d} "
                      f"loss={rec.train_loss:.4f}{acc}")
        self.finalize()
        return self.history

    @property
    def start_round(self) -> int:
        """First round ``run()`` will execute — 0 for a fresh trainer,
        the checkpointed next round after ``restore()``/``resume()``."""
        return self._start_round

    @property
    def health_report(self):
        """Latest HealthReport of the run-health monitor — None before
        the first round or when ExecConfig.health is off."""
        return None if self._health is None else self._health.last_report

    @property
    def best_accuracy(self):
        self._resolve_pending_eval()
        accs = [(r.test_accuracy, r.round) for r in self.history
                if r.test_accuracy is not None]
        return max(accs) if accs else (None, None)


    # ---- checkpointing (TrainerState <-> checkpoint/checkpoint.py) ----

    def state(self) -> TrainerState:
        """Snapshot the checkpoint unit. The staging producer (and the
        async engine) may have sampled rounds or waves beyond the last
        consumed one; the snapshot rolls RNG/sampler/schedule back to the
        consumed frontier using the per-round captures taken at sampling
        time, so a resumed trainer re-draws those rounds identically."""
        self.finalize()
        with self._sample_lock:
            # history carries every consumed round (including restored
            # ones after a resume), so its length IS the next round —
            # provided rounds were consumed sequentially; reject anything
            # else loudly instead of writing a silently-wrong checkpoint
            next_round = len(self.history)
            if [r.round for r in self.history] != list(range(next_round)):
                raise ValueError(
                    "save() requires rounds to have been run sequentially "
                    "from 0 (run_round(0), run_round(1), ...); history "
                    f"holds rounds {[r.round for r in self.history]}")
            # synchronous rounds: the consumed frontier IS the next round;
            # buffered-async: the engine's wave frontier
            frontier = (next_round if self._engine is None
                        else self._engine.wave_frontier)
            cap = self._round_caps.get(frontier)
            if cap is None:     # nothing sampled past the frontier
                cap = self._capture()
            schedule = [np.asarray(c) for c in self.schedule[:frontier]]
        return TrainerState(
            params=self.params, server_state=self.full_state(),
            round=next_round, max_batches=cap["max_batches"],
            rng_state=cap["rng"], sampler_state=cap["sampler"],
            schedule=schedule, history=list(self.history),
            runtime_state=cap.get("runtime"),
            opt_state=self._gather_state(self._opt_state))

    def _codec_echo(self) -> Optional[dict]:
        """JSON echo of the LOSSY codec configuration (identity is the
        no-codec path, so it normalizes to None): restore() compares it
        and fails loudly on a mismatch."""
        if not self._codec_lossy:
            return None
        return {"config": self._codec.config_dict(),
                "ef": self._ef is not None}

    def _algo_echo(self) -> dict:
        """JSON echo of everything that parameterizes the round — a
        resume with ANY of these changed cannot continue the run. The
        reference's route field (FedDPCHyper.use_kernel) is written as
        its default."""
        cls = type(self.algo.hyper).__name__
        return {
            "eta_l": self.algo_cfg.eta_l,
            "eta_g": self.algo_cfg.eta_g,
            "local_optimizer": self.algo_cfg.local_optimizer,
            "hyper": {"class": cls, **asdict(self.algo.hyper),
                      **_ROUTE_FIELDS.get(cls, {})},
        }

    def _chaos_echo(self) -> dict:
        return {"round_deadline": self.cfg.round_deadline,
                "fault_plan": (None if self.fault_plan is None
                               else self.fault_plan.config_dict()),
                "guard_config": (None if self._guard is None
                                 else self._guard.config.config_dict())}

    def _entry_to_reference(self, delta):
        """One async entry's whole delta -> the reference's tree: the
        params tree, or the codec's {"q", "scale", "zero"} trees (codes in
        the codec's dtype)."""
        if self._codec_lossy:
            delta = {**delta, "q": delta["q"].to(self._codec_dtype)}
            return bridge.payload_to_reference(delta, self.layout)
        return self.layout.unflatten(delta)

    def _inflight_rows(self, entries: List[BufferEntry]):
        """The in-flight entries' deltas at full width, in heap order: on
        one process the entries' own; across ranks, on the coordinator,
        each gathered from the client slice that holds it — within the
        slice's model group first (wide vectors all-gathered, a payload's
        per-leaf scalars taken from a model rank that holds the leaf),
        then broadcast over the client axis (exact). None on the other
        ranks. Every rank calls it alike."""
        if not self._mp:
            return [e.delta for e in entries]
        n = len(entries)
        if not n:
            return [] if distributed.is_coordinator() else None
        model = 1 if self._shards is None else self._shards.model
        c = distributed.process_index() // model
        # which client slice holds each entry: model rank 0 of the slice
        # counts it, one sum over the job
        owner = torch.zeros(n, dtype=torch.int64, device=self.device)
        if self._m == 0:
            for i, e in enumerate(entries):
                if e.delta is not None:
                    owner[i] = c + 1
        torch.distributed.all_reduce(owner)
        owner = (owner - 1).tolist()
        held = [i for i, e in enumerate(entries) if e.delta is not None]
        full = {}
        if held:
            parts = self._entry_parts([entries[i].delta for i in held])
            full = {k: self._widen(k, v) for k, v in parts.items()}
        if self._m != 0:
            return None
        # model rank 0 of each slice holds whole rows now; the client
        # axis of model rank 0 takes them to the coordinator
        group = self._client_group()
        rows = []
        for i in range(n):
            mine = owner[i] == c
            row = {}
            for key, shape, dtype in self._part_specs():
                buf = (full[key][held.index(i)].contiguous() if mine else
                       torch.empty(shape, dtype=dtype, device=self.device))
                torch.distributed.broadcast(buf, owner[i] * model,
                                            group=group)
                row[key] = buf
            rows.append(row if self._codec_lossy else row["delta"])
        return rows if distributed.is_coordinator() else None

    def _entry_parts(self, deltas) -> Dict[str, torch.Tensor]:
        """Held entries' deltas stacked per part: {"delta": (h, N_m)}, or
        a payload's {"q", "scale", "zero"}."""
        if not self._codec_lossy:
            return {"delta": torch.stack(deltas)}
        return {k: torch.stack([d[k] for d in deltas]) for k in deltas[0]}

    def _part_specs(self):
        """(part, whole row shape, dtype) of an entry's delta, as the
        broadcast carries it (codes in f32: exact)."""
        n, nleaves = self.layout.size, len(self.layout.shapes)
        if not self._codec_lossy:
            return [("delta", (n,), torch.float32)]
        return [("q", (n,), torch.float32),
                ("scale", (nleaves,), torch.float32),
                ("zero", (nleaves,), torch.float32)]

    def _widen(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """(h, N_m) held rows -> (h, N), (h, L_m) per-leaf scalars -> (h,
        L), over the model group (collectives of the slice's model ranks
        alone); f32 throughout."""
        x = x.float()
        if self._shards is None:
            return x
        if key in ("delta", "q"):
            return model_all_gather(x, self._model_group, self._shards)
        sh = self._shards
        nleaves = len(self.layout.shapes)
        ids = torch.from_numpy(sh.leaf_ids(self._m)).to(x.device)
        part = x.new_zeros((x.shape[0], nleaves))
        part[:, ids] = x
        parts = [torch.empty_like(part) for _ in range(sh.model)]
        torch.distributed.all_gather(parts, part, group=self._model_group)
        # each leaf from the first model rank that holds it
        first = {}
        for m in reversed(range(sh.model)):
            first.update({int(i): m for i in sh.leaf_ids(m)})
        pick = torch.tensor([first[i] for i in range(nleaves)],
                            device=x.device)
        g = torch.stack(parts)                        # (M, h, L)
        return g.gather(0, pick[None, None].expand(1, *part.shape))[0]

    def save(self, ckpt_dir: str, keep: int = 3) -> str:
        """Write the full TrainerState in the reference's format;
        ``resume(ckpt_dir, ...)`` then reproduces the uninterrupted run
        exactly. Device state reaches the host one leaf at a time."""
        st = self.state()
        rng = st.rng_state
        k = self.cfg.clients_per_round
        layout = self.layout
        aux_arrays = {
            "rng_keys": np.asarray(rng[1], np.uint32),
            "rng_pos": np.int64(rng[2]),
            "rng_has_gauss": np.int64(rng[3]),
            "rng_cached": np.float64(rng[4]),
            "round": np.int64(st.round),
            "max_batches": np.int64(-1 if st.max_batches is None
                                    else st.max_batches),
            "schedule": (np.stack(st.schedule).astype(np.int64)
                         if st.schedule else np.zeros((0, k), np.int64)),
        }
        if self._ef is not None:
            # error-feedback accumulator: params-shaped f32 leaves
            for i, leaf in enumerate(bridge.tree_leaves(
                    layout.unflatten(self._gather(self._ef)))):
                aux_arrays[f"codec_ef_{i}"] = leaf
        if st.opt_state is not None:
            # server-optimizer moments {"m", "v"}: params mirrors, the m
            # leaves then the v leaves; they advance at folds only, so a
            # mid-buffer async save carries the round-boundary state
            for i, leaf in enumerate(bridge.tree_leaves(
                    bridge.server_state_to_reference(st.opt_state,
                                                     layout))):
                aux_arrays[f"server_opt_{i}"] = leaf
        if self._engine is not None:
            # buffered-async streaming state: virtual clock + the
            # in-flight entries (dispatched, not yet folded) in heap
            # order, their deltas stacked per reference leaf with exact
            # dtypes (int8 codes stay int8)
            eng = self._engine
            entries = eng.inflight()
            aux_arrays.update({
                "async_clock": np.float64(eng.clock),
                "async_seq": np.int64(eng.seq),
                "async_wave_frontier": np.int64(eng.wave_frontier),
                "async_n_inflight": np.int64(len(entries)),
                "async_entry_client": np.asarray(
                    [e.client for e in entries], np.int64),
                "async_entry_wave": np.asarray(
                    [e.wave for e in entries], np.int64),
                "async_entry_version": np.asarray(
                    [e.version for e in entries], np.int64),
                "async_entry_seq": np.asarray(
                    [e.seq for e in entries], np.int64),
                "async_entry_finish": np.asarray(
                    [e.finish for e in entries], np.float64),
                "async_entry_loss": np.asarray(
                    [e.loss for e in entries], np.float32),
            })
            rows = self._inflight_rows(entries)
            if entries and rows is not None:
                per_entry = [bridge.tree_leaves(
                    self._entry_to_reference(d)) for d in rows]
                for i in range(len(per_entry[0])):
                    aux_arrays[f"async_delta_{i}"] = (
                        lambda i=i: torch.stack([p[i] for p in per_entry]))
        aux_json = {
            "format": 1,
            "algorithm": self.algo.name,
            "algo_config": self._algo_echo(),
            # informational, never compared
            "exec_mesh": {"shard_clients": self.cfg.shard_clients,
                          "shard_model": self.cfg.shard_model,
                          "devices": (0 if self.mesh is None
                                      else distributed.process_count())},
            "num_clients": self.num_clients,
            "clients_per_round": k,
            "sampler": {"class": type(self.sampler).__name__,
                        "config": self.sampler.config_dict(),
                        "state": st.sampler_state},
            "codec": self._codec_echo(),
            "server_opt": (None if self._server_opt is None
                           else self._server_opt.config_dict()),
            "history": [asdict(r) for r in st.history],
        }
        if self._health is not None:
            # observe() runs at consumption, never ahead of it, so the
            # detector's window checkpoints verbatim
            aux_json["health"] = {
                "config": self._health.config.config_dict(),
                "state": self._health.state_dict()}
        if self._engine is not None:
            aux_json["async"] = {
                "buffer_size": self._engine.buffer_size,
                "alpha": self._engine.alpha,
                "concurrency": self._engine.concurrency,
                "runtime": {"config": self._runtime.config_dict(),
                            "state": st.runtime_state or {}},
            }
        elif self._runtime is not None:
            # sync round-deadline regime: its runtime model's pre-draw
            # state is captured like the async one's
            aux_json["sync_runtime"] = {
                "config": self._runtime.config_dict(),
                "state": st.runtime_state or {}}
        if (self._guard is not None or self.fault_plan is not None
                or self.cfg.round_deadline is not None):
            # the guard's window is consumed-round state (observe() runs
            # at consumption), so it checkpoints verbatim
            chaos = self._chaos_echo()
            aux_json["chaos"] = {
                "round_deadline": chaos["round_deadline"],
                "fault_plan": chaos["fault_plan"],
                "guard": (None if self._guard is None else
                          {"config": chaos["guard_config"],
                           "state": self._guard.state_dict()}),
            }
        state = {"params": st.params,
                 "server_state": bridge.server_state_to_reference(
                     st.server_state, layout)}
        if not self._mp:
            return ckpt.save(ckpt_dir, st.round, state, keep=keep,
                             aux_arrays=aux_arrays, aux_json=aux_json)
        # rank 0 writes (every rank holds the same replicated state); the
        # barrier keeps the others from reading or rotating past a save
        # still in flight
        if distributed.is_coordinator():
            path = ckpt.save(ckpt_dir, st.round, state, keep=keep,
                             aux_arrays=aux_arrays, aux_json=aux_json)
        else:
            path = ckpt.step_dir(ckpt_dir, st.round)
        self._save_seq += 1
        distributed.barrier(f"t{self._mp_seq}/save/{self._save_seq}")
        return path

    def _check_echoes(self, meta: dict) -> None:
        """Every configuration echo of a checkpoint against this trainer,
        in the reference's order: a mismatch cannot continue the run, so
        it fails here instead of diverging silently."""
        if meta["algorithm"] != self.algo.name:
            raise ValueError(f"checkpoint is for {meta['algorithm']!r}, "
                             f"trainer runs {self.algo.name!r}")
        for field_name, mine in (("num_clients", self.num_clients),
                                 ("clients_per_round",
                                  self.cfg.clients_per_round),
                                 ("algo_config", self._algo_echo())):
            saved = meta.get(field_name)
            if field_name == "algo_config":
                saved, mine = _without_route(saved), _without_route(mine)
            if saved is not None and saved != mine:
                raise ValueError(
                    f"checkpoint has {field_name}={saved}, trainer was "
                    f"built with {mine} — resume with the original "
                    "configuration")
        saved_sampler = meta["sampler"].get("class")
        if saved_sampler != type(self.sampler).__name__:
            raise ValueError(
                f"checkpoint was sampled by {saved_sampler}, trainer uses "
                f"{type(self.sampler).__name__} — resume with the same "
                "sampler the original run used")
        saved_cfg = meta["sampler"].get("config")
        if saved_cfg is not None:
            saved_cfg = normalize_sampler_config(saved_cfg)
        if saved_cfg is not None and saved_cfg != self.sampler.config_dict():
            raise ValueError(
                f"checkpoint sampler was built as {saved_cfg}, trainer's "
                f"is {self.sampler.config_dict()} — resume with the "
                "original sampler parameters")
        meta_async = meta.get("async")
        if (meta_async is not None) != (self._engine is not None):
            raise ValueError(
                "checkpoint and trainer disagree on the buffered-async "
                f"regime (checkpoint async={meta_async is not None}, "
                f"trainer async={self._engine is not None}) — the wave/"
                "arrival trajectory is part of the run and cannot switch "
                "mid-stream")
        if self._engine is not None:
            eng = self._engine
            for knob in ("buffer_size", "alpha", "concurrency"):
                if meta_async[knob] != getattr(eng, knob):
                    raise ValueError(
                        f"checkpoint has async {knob}={meta_async[knob]}, "
                        f"trainer was built with {getattr(eng, knob)} — "
                        "resume with the original async configuration")
            rt = meta_async["runtime"]
            if rt["config"] != self._runtime.config_dict():
                raise ValueError(
                    f"checkpoint runtime model was built as "
                    f"{rt['config']}, trainer's is "
                    f"{self._runtime.config_dict()} — resume with the "
                    "original runtime model")
        meta_sync_rt = meta.get("sync_runtime")
        if meta_sync_rt is not None:
            if self._engine is not None or self._runtime is None:
                raise ValueError(
                    "checkpoint carries a sync-deadline runtime model but "
                    "the trainer was not built with one — resume with the "
                    "original ExecConfig(round_deadline=...) and runtime")
            if meta_sync_rt["config"] != self._runtime.config_dict():
                raise ValueError(
                    f"checkpoint sync runtime model was built as "
                    f"{meta_sync_rt['config']}, trainer's is "
                    f"{self._runtime.config_dict()} — resume with the "
                    "original runtime model")
        meta_chaos = meta.get("chaos")
        if meta_chaos is not None:
            mine_chaos = self._chaos_echo()
            saved_chaos = {
                "round_deadline": meta_chaos.get("round_deadline"),
                "fault_plan": meta_chaos.get("fault_plan"),
                "guard_config": (meta_chaos["guard"] or {}).get("config")
                                if meta_chaos.get("guard") is not None
                                else None,
            }
            # JSON round-trips tuples as lists: normalize through the
            # same encoder before comparing
            if (json.loads(json.dumps(mine_chaos, default=float))
                    != saved_chaos):
                raise ValueError(
                    f"checkpoint chaos configuration {saved_chaos} does "
                    f"not match the trainer's {mine_chaos} — resume with "
                    "the original guard/fault-plan/deadline configuration")
        elif (self._guard is not None or self.fault_plan is not None
              or self.cfg.round_deadline is not None):
            raise ValueError(
                "trainer was built with chaos hardening (guard/fault "
                "plan/deadline) but the checkpoint has none — resume "
                "with the original configuration")
        if meta.get("codec") != self._codec_echo():
            raise ValueError(
                f"checkpoint codec configuration {meta.get('codec')} "
                f"does not match the trainer's {self._codec_echo()} — "
                "resume with the original codec/codec_ef configuration")
        mine_sopt = (None if self._server_opt is None
                     else self._server_opt.config_dict())
        if meta.get("server_opt") != mine_sopt:
            raise ValueError(
                f"checkpoint server optimizer {meta.get('server_opt')} "
                f"does not match the trainer's {mine_sopt} — resume "
                "with the original server_opt configuration")
        meta_health = meta.get("health")
        if (meta_health is not None) != (self._health is not None):
            raise ValueError(
                "checkpoint and trainer disagree on the run-health "
                f"monitor (checkpoint health={meta_health is not None}, "
                f"trainer health={self._health is not None}) — resume "
                "with the original ExecConfig.health configuration")
        if (meta_health is not None
                and meta_health["config"] != self._health.config
                .config_dict()):
            raise ValueError(
                f"checkpoint health configuration {meta_health['config']} "
                f"does not match the trainer's "
                f"{self._health.config.config_dict()} — resume with the "
                "original health detector parameters")

    @staticmethod
    def _load_leaves(dest, arrays: dict, prefix: str, what: str) -> None:
        """Copy aux arrays ``<prefix>0..`` into the leaves of ``dest``
        (views into the trainer's flat buffers), shapes checked."""
        leaves = bridge.tree_leaves(dest)
        if f"{prefix}0" not in arrays:
            raise ValueError(
                f"trainer expects {what} but the checkpoint carries none "
                "— resume with the original configuration")
        for i, t in enumerate(leaves):
            a = arrays[f"{prefix}{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{prefix}{i}: shape mismatch "
                                 f"{tuple(t.shape)} vs {a.shape}")
            t.copy_(ckpt.from_host(a, t.dtype))

    def _restore_inflight(self, arrays: dict) -> List[BufferEntry]:
        """The checkpoint's in-flight entries, in heap order. Across ranks
        entry j goes to client slice j mod (client slices) — a rule every
        rank computes alike, whatever process count wrote the checkpoint
        — whose ranks keep its delta (on the model axis their shard's
        columns); the other ranks keep the entry without it."""
        n = int(arrays["async_n_inflight"])
        if not n:
            return []
        keep = list(range(n))
        if self._mp:
            model = 1 if self._shards is None else self._shards.model
            slices = distributed.process_count() // model
            c = distributed.process_index() // model
            keep = [j for j in range(n) if j % slices == c]
        layout, skel = self.layout, self.layout.skeleton
        nleaves = len(layout.shapes)
        rows = torch.as_tensor(keep, dtype=torch.int64)
        stacked = [ckpt.from_host(arrays[f"async_delta_{i}"])[rows]
                   for i in range(nleaves * (3 if self._codec_lossy
                                             else 1))]

        def tree(base):
            return bridge.tree_map(lambda i: stacked[base + i], skel)
        sh, m = self._shards, self._m
        if self._codec_lossy:
            held = bridge.payload_from_reference(
                {"q": tree(0), "scale": tree(nleaves),
                 "zero": tree(2 * nleaves)}, layout, self.device)
            if sh is not None:
                ids = torch.from_numpy(sh.leaf_ids(m)).to(self.device)
                held = {"q": sh.scatter(held["q"], m),
                        "scale": held["scale"][:, ids].contiguous(),
                        "zero": held["zero"][:, ids].contiguous()}
            deltas = [{k: v[i] for k, v in held.items()}
                      for i in range(len(keep))]
        else:
            held = bridge.flat_from_reference(tree(0), layout, self.device)
            if sh is not None:
                held = sh.scatter(held, m)
            deltas = list(held)
        by_row = dict(zip(keep, deltas))
        return [BufferEntry(
            client=int(arrays["async_entry_client"][j]),
            wave=int(arrays["async_entry_wave"][j]),
            version=int(arrays["async_entry_version"][j]),
            seq=int(arrays["async_entry_seq"][j]),
            finish=float(arrays["async_entry_finish"][j]),
            loss=float(arrays["async_entry_loss"][j]),
            delta=by_row.get(j)) for j in range(n)]

    def restore(self, ckpt_dir: str, step: Optional[int] = None
                ) -> "FederatedTrainer":
        """Load a TrainerState saved by ``save`` (by this package or the
        reference) into this freshly constructed trainer; ``run()`` then
        continues from the saved round. Configs/loss_fn/source are NOT
        checkpointed — construct the trainer exactly as the original run
        did. The newest step whose digests verify is taken (a warning for
        each corrupt one skipped); an explicit ``step`` never falls
        back."""
        if self._pipeline.started or self.history or self.schedule:
            # a used trainer has a producer drawing this RNG and rounds
            # staged past the restore point: rewinding it would race
            raise RuntimeError(
                "restore() requires a freshly constructed trainer that "
                "has not run any rounds — use FederatedTrainer.resume()")
        step = ckpt.resolve_step(ckpt_dir, step)
        arrays, meta = ckpt.load_aux(ckpt_dir, step)
        if meta is None or "rng_keys" not in arrays:
            raise ValueError(f"{ckpt_dir} has no TrainerState sidecars — "
                             "was it written by FederatedTrainer.save()?")
        self._check_echoes(meta)
        layout = self.layout
        # straight into the trainer's buffers, leaf by leaf; on the model
        # axis into whole temporaries, whose shards are then kept
        flat, state = self._gather(self.flat), self.full_state()
        ef = None if self._ef is None else self._gather(self._ef)
        opt = self._gather_state(self._opt_state)
        ckpt.restore_into(ckpt_dir, {
            "params": layout.unflatten(flat),
            "server_state": bridge.server_state_to_reference(
                state, layout)}, step=step)
        if ef is not None:
            self._load_leaves(layout.unflatten(ef), arrays, "codec_ef_",
                              "an error-feedback accumulator")
        if opt is not None:
            self._load_leaves(bridge.server_state_to_reference(
                opt, layout), arrays, "server_opt_",
                "server-optimizer moment state")
        if self._shards is not None:
            keep = lambda v: (v if v.dim() == 0
                              else self._shards.scatter(v, self._m))
            self.flat = keep(flat)
            self.server_state = {k: keep(v) for k, v in state.items()}
            self._ef = None if ef is None else keep(ef)
            self._opt_state = (None if opt is None else
                               {k: keep(v) for k, v in opt.items()})
        self.rng.set_state(("MT19937",
                            np.asarray(arrays["rng_keys"], np.uint32),
                            int(arrays["rng_pos"]),
                            int(arrays["rng_has_gauss"]),
                            float(arrays["rng_cached"])))
        mb = int(arrays["max_batches"])
        self._pipeline.max_batches = None if mb < 0 else mb
        self._start_round = int(arrays["round"])
        self.schedule = [row for row in np.asarray(arrays["schedule"])]
        self.history = [RoundRecord(**r) for r in meta["history"]]
        if meta["sampler"].get("state"):
            self.sampler.load_state_dict(meta["sampler"]["state"])
        if meta.get("sync_runtime", {}).get("state"):
            self._runtime.load_state_dict(meta["sync_runtime"]["state"])
        if (meta.get("chaos") or {}).get("guard") is not None \
                and self._guard is not None:
            gst = meta["chaos"]["guard"].get("state")
            if gst:
                self._guard.load_state_dict(gst)
        if meta.get("health") is not None:
            self._health.load_state_dict(meta["health"]["state"])
        if self._engine is not None:
            eng = self._engine
            rt_state = meta["async"]["runtime"].get("state")
            if rt_state:
                self._runtime.load_state_dict(rt_state)
            eng.clock = float(arrays["async_clock"])
            eng.seq = int(arrays["async_seq"])
            eng.wave_frontier = int(arrays["async_wave_frontier"])
            # folds performed == server rounds consumed
            eng.version = self._start_round
            eng.load_inflight(self._restore_inflight(arrays))
        self._round_caps.clear()
        return self

    @classmethod
    def resume(cls, ckpt_dir: str, loss_fn: Callable, params,
               num_clients: int, data, cfg: Optional[ExecConfig] = None,
               eval_fn: Optional[Callable] = None, *,
               algo: Optional[AlgoConfig] = None,
               sampler: Optional[ClientSampler] = None,
               runtime: Optional[ClientRuntimeModel] = None,
               fault_plan=None, step: Optional[int] = None,
               device=None) -> "FederatedTrainer":
        """Fresh-process resume: construct the trainer exactly as the
        original run did (on ``device``: a checkpoint written on the card
        resumes on the CPU and the reverse), then restore the saved
        TrainerState. ``run()`` continues from the checkpointed round and
        reproduces the uninterrupted run — including mid-buffer async
        state (pass the same ``runtime`` model and ``fault_plan``)."""
        tr = cls(loss_fn, params, num_clients, data, cfg, eval_fn,
                 algo=algo, sampler=sampler, runtime=runtime,
                 fault_plan=fault_plan, device=device)
        return tr.restore(ckpt_dir, step=step)
