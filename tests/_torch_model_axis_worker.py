"""One rank of the port's model-axis check (tests/
test_torch_model_axis.py), spawned four times by
launch/distributed.spawn_local on gloo. Imports neither JAX nor the
reference.

The rank runs every cell of _torch_matrix_task.MODEL_CELLS (the (1 x 4)
and (2 x 2) meshes; staged2d also with prefetch off), a (2 x 2) run cut
at round 2 and saved (rank 0 writes), the resume of a one-process
checkpoint the test wrote, and the training CLI with --model-shards 2.
It dumps per run: the gathered params and server state, its own shards,
the history, its place on the mesh and the bytes it holds at rest, its
collectives, and how often each FedDPC kernel's wrapper (and
int8_sr_quantize) was called on its rank.
"""
import argparse
import collections
import json
import os
import sys
from dataclasses import asdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.launch import distributed  # noqa: E402

CTX = distributed.maybe_initialize()        # before any device query

import numpy as np                          # noqa: E402

from _torch_matrix_task import (MODEL_CELLS, MODEL_CLI_ARGS,  # noqa: E402
                                ROUNDS, model_trainer)
from repro_torch.kernels.feddpc_project import ops as k_ops  # noqa: E402
from repro_torch.kernels.int8_sr import ops as sr_ops        # noqa: E402

CALLS = collections.Counter()
COUNTED = ((k_ops, ("feddpc_dots", "feddpc_guard_dots",
                    "feddpc_batched_epilogue",
                    "feddpc_dequant_batched_epilogue")),
           (sr_ops, ("int8_sr_quantize",)))


def _count(mod, name):
    fn = getattr(mod, name)

    def wrapper(*a, **kw):
        CALLS[name] += 1
        return fn(*a, **kw)
    setattr(mod, name, wrapper)


for _mod, _names in COUNTED:
    for _name in _names:
        _count(_mod, _name)


def dump(out, tag, tr):
    rank = CTX.process_id
    arrays = {"params": tr.full_params().numpy(),
              "shard_params": tr.flat.numpy()}
    for k, v in tr.full_state().items():
        arrays[f"state_{k}"] = v.numpy()
    for k, v in tr.server_state.items():
        arrays[f"shard_state_{k}"] = v.numpy()
    if tr._opt_state is not None:
        for k, v in tr._opt_state.items():
            arrays[f"shard_opt_{k}"] = v.numpy()
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), **arrays)
    meta = {"history": [asdict(r) for r in tr.history],
            "schedule": [np.asarray(s).tolist()
                         for s in tr.state().schedule],
            "shard": tr.shard_info(), "calls": dict(CALLS),
            "collectives": [[name for name, _ in r]
                            for r in tr.collective_log]}
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def run(out, tag, cell, **kw):
    CALLS.clear()
    with model_trainer(cell, **kw) as tr:
        tr.run()
    dump(out, tag, tr)


def fl_round_steps(out):
    """Two rounds of the cross-silo round (round.make_fl_round_step) on
    the (2 x 2) mesh: this rank's share of FL_SILOS silos, params and
    delta_prev as its shards; rank 0 dumps the gathered results."""
    import torch
    from repro_torch import bridge
    from repro_torch.core.round import make_fl_round_step, model_all_gather
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.sharding.layout import ShardLayout
    from repro_torch.sharding.rules import local_row_range, model_row_split
    from _torch_matrix_task import (ETA_G, ETA_L, FL_SILOS, fl_batches,
                                    loss_fn, make_params)
    mesh = make_cohort_mesh(model=2)
    params = make_params()
    layout = bridge.layout_of(params)
    shards = ShardLayout.from_mesh(layout, mesh)
    c, m = divmod(CTX.process_id, 2)
    lo, hi = model_row_split(*local_row_range(c, 2, FL_SILOS), 2)[m]
    batches = bridge.tree_map(lambda x: x[lo:hi], fl_batches())
    out_arrays = {}
    for name in ("feddpc", "fedavg"):
        step = make_fl_round_step(loss_fn, layout, ETA_L, ETA_G, 0.7, name,
                                  mesh=mesh, params_template=params)
        p = shards.scatter(layout.flatten(params), m)
        dp = torch.zeros_like(p)
        group = mesh["model"].get_group()
        for t in range(2):
            p, dp, metrics = step(p, dp, batches)
            out_arrays[f"{name}_{t}_params"] = model_all_gather(
                p, group, shards).numpy()
            out_arrays[f"{name}_{t}_dp"] = model_all_gather(
                dp, group, shards).numpy()
            for k, v in metrics.items():
                out_arrays[f"{name}_{t}_m_{k}"] = np.asarray(float(v))
    np.savez(os.path.join(out, f"fl_round_r{CTX.process_id}.npz"),
             **out_arrays)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    assert CTX is not None and CTX.num_processes == 4, CTX
    for cell in MODEL_CELLS:
        run(args.out, cell, cell)
        if ":staged2d:" in cell:
            run(args.out, cell + ":noprefetch", cell, prefetch=False)
    # cut at round 2: rank 0 writes, the barrier makes it visible to all
    cell = "feddpc:sharded2d:2"
    ckpt = os.path.join(args.out, "ckpt2d")
    CALLS.clear()
    with model_trainer(cell) as tr:
        tr.run_round(0)
        tr.run_round(1)
        path = tr.save(ckpt)
        assert os.path.isdir(path), path
        for t in range(2, ROUNDS):
            tr.run_round(t)
    dump(args.out, "cut", tr)
    # a one-process checkpoint, resumed on the (2 x 2) mesh
    CALLS.clear()
    tr = model_trainer(cell)
    tr.restore(os.path.join(args.out, "ckpt1"))
    with tr:
        tr.run()
    dump(args.out, "resumed", tr)
    fl_round_steps(args.out)
    # the training CLI, on the job this rank has joined
    from repro_torch.launch import train
    train.main(MODEL_CLI_ARGS + ["--device", "cpu", "--out",
                                 os.path.join(args.out, "cli.json")])
    print("TORCH_MODEL_AXIS_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
