"""tests/_matrix_task.py's toy FL task in torch, for the port's
multi-process checks: the same 2-layer MLP regression, initial params
and ragged per-client minibatches (numpy draws), and the cells the
two-process job runs. Imports neither JAX nor the reference, so a
spawned rank can load it; it queries no device at import time."""
import numpy as np
import torch

NUM_CLIENTS = 10
K = 4           # the edge cells' cohort: 2 edges over 2 ranks
ROUNDS = 3
SEED = 5
ETA_L, ETA_G = 0.05, 0.1

# the two-process job's cells: rule, cohort size, ExecConfig overrides
# (shard_clients is added on the ranks) and FaultPlan.seeded(0, ...)
# arguments
CELLS = {
    "feddpc": ("feddpc", K, {"edges": 2}, None),
    "fedavg": ("fedavg", K, {"edges": 2}, None),
    "fedvarp": ("fedvarp", K, {"edges": 2}, None),
    "feddpc_edge_drop": ("feddpc", K, {"edges": 2},
                         {"edge_drop_rounds": (1,),
                          "edge_drop_edges": (1,)}),
    "feddpc_int8_ef": ("feddpc", K, {"edges": 2, "codec": "int8",
                                     "codec_ef": True}, None),
    "feddpc_guard": ("feddpc", K, {"edges": 2, "guard": True},
                     {"nan_rate": 0.3}),
    "feddpc_fedadam": ("feddpc", K, {"edges": 2, "server_opt": "fedadam"},
                       None),
    # K = 3 over 2 ranks pads to 4: rank 1 holds one client and a dummy
    "feddpc_k3": ("feddpc", 3, {}, None),
    # 3 edges of 2 rows over 2 ranks of 3: each rank folds two pieces,
    # one of them half an edge
    "feddpc_k6_edges3": ("feddpc", 6, {"edges": 3}, None),
}


# the training CLI's run in the job (with --shard-clients) and in the
# reference's CLI: LeNet5, K = 4 of 8 clients, two edges
CLI_ARGS = ["--model", "lenet5", "--rounds", "2", "--clients", "8",
            "--participation", "0.5", "--samples-per-class", "20",
            "--batch-size", "16", "--eval-every", "1", "--edges", "2"]


def loss_fn(p, batch):
    h = torch.tanh(batch["x"] @ p["w1"] + p["b1"])
    pred = h @ p["w2"] + p["b2"]
    return torch.mean((pred - batch["y"]) ** 2)


def make_params(seed=0):
    r = np.random.RandomState(seed)
    return {"w1": (r.randn(8, 16) * 0.3).astype(np.float32),
            "b1": np.zeros((16,), np.float32),
            "w2": (r.randn(16, 4) * 0.3).astype(np.float32),
            "b2": np.zeros((4,), np.float32)}


def batch_fn(c, t):
    """(c % 2) + 1 minibatches — cohorts are ragged by construction."""
    r = np.random.RandomState(1000 * c + t)
    return [{"x": r.randn(8, 8).astype(np.float32),
             "y": r.randn(8, 4).astype(np.float32)}
            for _ in range((c % 2) + 1)]


def port_trainer(cell, **exec_kw):
    """The port's trainer of a cell on the CPU; ``exec_kw`` overrides its
    ExecConfig (shard_clients, vectorize, prefetch, rounds)."""
    from repro_torch.core import api
    from repro_torch.core.faults import FaultPlan
    name, k, cell_kw, plan = CELLS[cell]
    cfg = api.ExecConfig(**{"rounds": ROUNDS, "clients_per_round": k,
                            "seed": SEED, "eval_every": 10 ** 9,
                            **cell_kw, **exec_kw})
    return api.FederatedTrainer(
        loss_fn, make_params(), NUM_CLIENTS, batch_fn, cfg,
        algo=api.AlgoConfig(name=name, eta_l=ETA_L, eta_g=ETA_G),
        fault_plan=None if plan is None else FaultPlan.seeded(0, **plan),
        device="cpu")


# the model axis's four-rank job (tests/test_torch_model_axis.py): cell
# -> (rule, EXEC_REGIMES name, model shards, more ExecConfig overrides,
# FaultPlan.seeded(0, ...) arguments). shard_model 4 is the regime
# table's (1 x 4) mesh; 2 is a (2 x 2) mesh
MODEL_REGIMES = ("sharded2d", "staged2d", "codec_int8_2d",
                 "server_fedadam_2d", "server_fedyogi_2d")
MODEL_CELLS = {
    **{f"feddpc:{reg}:{m}": ("feddpc", reg, m, {}, None)
       for m in (4, 2) for reg in MODEL_REGIMES},
    **{f"{name}:sharded2d:{m}": (name, "sharded2d", m, {}, None)
       for name in ("fedavg", "fedvarp") for m in (4, 2)},
    "feddpc:guard:2": ("feddpc", "sharded2d", 2, {"guard": True},
                       {"nan_rate": 0.3}),
    "feddpc:int8_sr:2": ("feddpc", "sharded2d", 2, {"codec": "int8_sr"},
                         None),
}
MODEL_CLI_ARGS = CLI_ARGS + ["--shard-clients", "--model-shards", "2"]


def model_cell_kw(cell, sharded=True):
    """A model cell's rule, ExecConfig overrides and fault plan; with
    ``sharded=False`` the same run in one process (no mesh keys)."""
    from repro_torch.core.api import EXEC_REGIMES
    name, regime, m, more, plan = MODEL_CELLS[cell]
    kw = {**EXEC_REGIMES[regime], **more}
    if sharded:
        kw["shard_model"] = m
    else:
        kw.pop("shard_clients")
        kw.pop("shard_model")
    return name, kw, plan


def model_trainer(cell, sharded=True, **exec_kw):
    """The port's trainer of a model cell on the CPU, K clients a round."""
    from repro_torch.core import api
    from repro_torch.core.faults import FaultPlan
    name, kw, plan = model_cell_kw(cell, sharded)
    cfg = api.ExecConfig(**{"rounds": ROUNDS, "clients_per_round": K,
                            "seed": SEED, "eval_every": 10 ** 9, **kw,
                            **exec_kw})
    return api.FederatedTrainer(
        loss_fn, make_params(), NUM_CLIENTS, batch_fn, cfg,
        algo=api.AlgoConfig(name=name, eta_l=ETA_L, eta_g=ETA_G),
        fault_plan=None if plan is None else FaultPlan.seeded(0, **plan),
        device="cpu")


# the cross-silo round's batches (round.make_fl_round_step): FL_SILOS
# silos, 2 all-valid minibatches each
FL_SILOS = 4


def fl_batches():
    rng = np.random.RandomState(3)
    return {"x": torch.from_numpy(rng.randn(FL_SILOS, 2, 8, 8)
                                  .astype(np.float32)),
            "y": torch.from_numpy(rng.randn(FL_SILOS, 2, 8, 4)
                                  .astype(np.float32))}


# the async job's cells (tests/test_torch_async_ranks.py): cell -> (rule,
# ExecConfig overrides — an EXEC_REGIMES name or a dict —, model shards
# (1: a (4 x 1) mesh, 2: (2 x 2)), runtime model ("exponential" or None:
# deterministic), sampler, FaultPlan.seeded(0, ...) arguments). K = 4 is a
# multiple of both meshes' client slices, so no wave is padded and
# int8_sr draws the one-process noise
ASYNC_ROUNDS = 4
ASYNC_CUT = 2
ASYNC_REGIMES = ("async_buffer", "codec_int8_async", "server_fedadam_async")
STRAGGLERS = {"async_buffer": True, "buffer_size": 2,
              "async_concurrency": 3}
ASYNC_CELLS = {
    **{f"feddpc:{reg}:{m}": ("feddpc", reg, m, None, "uniform", None)
       for m in (1, 2) for reg in ASYNC_REGIMES},
    **{f"feddpc:stragglers:{m}": ("feddpc", STRAGGLERS, m, "exponential",
                                  "uniform", None) for m in (1, 2)},
    "fedvarp:markov:2": ("fedvarp", STRAGGLERS, 2, "exponential", "markov",
                         None),
    "feddpc:int8_sr_ef:2": ("feddpc", {**STRAGGLERS, "codec": "int8_sr",
                                       "codec_ef": True}, 2, "exponential",
                            "uniform", None),
    "feddpc:guard_int8:2": ("feddpc", {**STRAGGLERS, "codec": "int8",
                                       "guard": True, "round_deadline": 0.1},
                            2, "exponential", "uniform", {"nan_rate": 0.3}),
}
# run again with prefetch off; cut mid-buffer at ASYNC_CUT (tag -> cell)
ASYNC_NOPREFETCH = ("feddpc:stragglers:1", "feddpc:int8_sr_ef:2")
ASYNC_CUTS = {"cut": "feddpc:stragglers:2", "cut_sr": "feddpc:int8_sr_ef:2"}
# the training CLI's async run: the ranks add --shard-clients
# --model-shards 2
ASYNC_CLI_ARGS = ["--model", "lenet5", "--rounds", "2", "--clients", "8",
                  "--participation", "0.5", "--samples-per-class", "20",
                  "--batch-size", "16", "--eval-every", "1",
                  "--async-buffer", "--runtime", "exponential",
                  "--buffer-size", "2", "--async-concurrency", "3"]


def async_cell_kw(cell, sharded=True):
    """An async cell's rule, ExecConfig overrides, runtime name, sampler
    name and fault plan; ``sharded=False`` is the same run in one
    process."""
    from repro_torch.core.api import EXEC_REGIMES
    name, regime, m, rt, sampler, plan = ASYNC_CELLS[cell]
    kw = dict(EXEC_REGIMES[regime] if isinstance(regime, str) else regime)
    if sharded:
        kw.update(shard_clients=True, shard_model=m)
    return name, kw, rt, sampler, plan


def async_trainer(cell, sharded=True, **exec_kw):
    """The port's trainer of an async cell on the CPU."""
    from repro_torch.core import api
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.runtime import ExponentialRuntime
    from repro_torch.core.samplers import MarkovSampler, UniformSampler
    name, kw, rt, sampler, plan = async_cell_kw(cell, sharded)
    cfg = api.ExecConfig(**{"rounds": ASYNC_ROUNDS, "clients_per_round": K,
                            "seed": SEED, "eval_every": 10 ** 9, **kw,
                            **exec_kw})
    return api.FederatedTrainer(
        loss_fn, make_params(), NUM_CLIENTS, batch_fn, cfg,
        algo=api.AlgoConfig(name=name, eta_l=ETA_L, eta_g=ETA_G),
        sampler=(MarkovSampler(NUM_CLIENTS, K) if sampler == "markov"
                 else UniformSampler(NUM_CLIENTS, K)),
        runtime=ExponentialRuntime(mean=1.0) if rt else None,
        fault_plan=None if plan is None else FaultPlan.seeded(0, **plan),
        device="cpu")


class _PopLog:
    """An async engine module's ``heapq`` with every pop logged: the
    arrivals' [client, wave, version], in arrival order."""

    def __init__(self, heapq_module):
        self._heapq = heapq_module
        self.log = []

    def __getattr__(self, name):
        return getattr(self._heapq, name)

    def heappop(self, heap):
        item = self._heapq.heappop(heap)
        e = item[2]
        self.log.append([int(e.client), int(e.wave), int(e.version)])
        return item


def record_arrivals(trainer, engine_module):
    """Record each fold of ``trainer``'s async engine (an engine of
    ``engine_module``, either package's): the version it folds at and
    its arrivals' [client, wave, version], in arrival order. Returns the
    list the folds land in."""
    if not isinstance(engine_module.heapq, _PopLog):
        engine_module.heapq = _PopLog(engine_module.heapq)
    log = engine_module.heapq.log
    engine = trainer._engine
    run = engine.run_server_round
    folds = []

    def recorded(t, params, server_state):
        mark, version = len(log), engine.version
        out = run(t, params, server_state)
        folds.append({"version": int(version), "arrivals": log[mark:]})
        return out
    engine.run_server_round = recorded
    return folds
