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
