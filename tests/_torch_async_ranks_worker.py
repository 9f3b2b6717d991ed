"""One rank of the port's buffered-async check across ranks (tests/
test_torch_async_ranks.py), spawned four times by
launch/distributed.spawn_local on gloo. Imports neither JAX nor the
reference.

The rank runs every cell of _torch_matrix_task.ASYNC_CELLS (on a (4 x 1)
or a (2 x 2) mesh), two of them again with prefetch off, the (4 x 1)
mesh's synchronous round beside the async anchor, two (2 x 2) runs cut
mid-buffer and saved (rank 0 writes), the resume of a one-process
mid-buffer checkpoint the test wrote on (4 x 1), and the training CLI
with --shard-clients --async-buffer --model-shards 2. It dumps per run:
the gathered params and server state, its own shards, the history, its
place on the mesh and the bytes it holds at rest, each fold's arrivals
and the buffer positions it held, its collectives, and how often each
FedDPC kernel's wrapper (and int8_sr_quantize) was called on its rank.
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

from _torch_matrix_task import (ASYNC_CELLS, ASYNC_CLI_ARGS,  # noqa: E402
                                ASYNC_CUT, ASYNC_CUTS, ASYNC_NOPREFETCH,
                                ASYNC_ROUNDS, async_trainer,
                                record_arrivals)
from repro_torch.core import async_engine                    # noqa: E402
from repro_torch.kernels.feddpc_project import ops as k_ops  # noqa: E402
from repro_torch.kernels.int8_sr import ops as sr_ops        # noqa: E402

CALLS = collections.Counter()
COUNTED = ((k_ops, ("feddpc_dots", "feddpc_guard_dots",
                    "feddpc_buffer_fold", "feddpc_dequant_buffer_fold",
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


def record_held(tr):
    """The buffer positions this rank held at each fold."""
    engine, held = tr._engine, []
    fold = engine.fold

    def wrapped(*a, **kw):
        held.append([int(i) for i in kw["held"]])
        return fold(*a, **kw)
    engine.fold = wrapped
    return held


def dump(out, tag, tr, folds=None, held=None):
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
        for k, v in tr._gather_state(tr._opt_state).items():
            arrays[f"opt_{k}"] = v.numpy()
    if tr._ef is not None:
        arrays["ef"] = tr._gather(tr._ef).numpy()
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), **arrays)
    meta = {"history": [asdict(r) for r in tr.history],
            "schedule": [np.asarray(s).tolist()
                         for s in tr.state().schedule],
            "shard": tr.shard_info(), "calls": dict(CALLS),
            "folds": folds, "held": held,
            "collectives": [[name for name, _ in r]
                            for r in tr.collective_log]}
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def run(out, tag, cell, cut=None, **kw):
    CALLS.clear()
    with async_trainer(cell, **kw) as tr:
        folds = held = None
        if tr._engine is not None:
            folds = record_arrivals(tr, async_engine)
            held = record_held(tr)
        for t in range(ASYNC_ROUNDS):
            if t == cut:
                path = tr.save(os.path.join(out, f"ckpt_{tag}"))
                assert os.path.isdir(path), path
            tr.run_round(t)
        tr.finalize()
    dump(out, tag, tr, folds, held)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    assert CTX is not None and CTX.num_processes == 4, CTX
    for cell in ASYNC_CELLS:
        run(args.out, cell, cell)
        if cell in ASYNC_NOPREFETCH:
            run(args.out, cell + ":noprefetch", cell, prefetch=False)
    # the (4 x 1) mesh's synchronous round, the async anchor's partner
    run(args.out, "sync:1", "feddpc:async_buffer:1", async_buffer=False)
    for tag, cell in ASYNC_CUTS.items():
        run(args.out, tag, cell, cut=ASYNC_CUT)
    # a one-process mid-buffer checkpoint, resumed on the (4 x 1) mesh
    CALLS.clear()
    tr = async_trainer("feddpc:stragglers:1")
    tr.restore(os.path.join(args.out, "ckpt1"))
    inflight = sum(e.delta is not None for e in tr._engine.inflight())
    with tr:
        tr.run()
    dump(args.out, "resumed", tr)
    with open(os.path.join(args.out, f"resumed_held_r{CTX.process_id}"),
              "w") as fh:
        fh.write(str(inflight))
    # the training CLI, on the job this rank has joined
    from repro_torch.launch import train
    train.main(ASYNC_CLI_ARGS + [
        "--shard-clients", "--model-shards", "2", "--device", "cpu",
        "--out", os.path.join(args.out, "cli.json")])
    print("TORCH_ASYNC_RANKS_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
