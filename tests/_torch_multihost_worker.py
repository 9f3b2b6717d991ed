"""One rank of the port's two-process check (tests/
test_torch_multihost.py), spawned by launch/distributed.spawn_local on
gloo. Imports neither JAX nor the reference.

The rank runs every cell of _torch_matrix_task.CELLS with shard_clients
(prefetch on, then off), a run cut at round 2 and saved (rank 0
writes), the resume of a single-process checkpoint the test wrote, and
the training CLI, and dumps what each left — params, server state,
history, schedule, its rows and its collectives — under --out, one file
set per rank. The test holds them against the serial runs of both
packages.
"""
import argparse
import json
import os
import sys
from dataclasses import asdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch.launch import distributed  # noqa: E402

CTX = distributed.maybe_initialize()        # before any device query

import numpy as np                          # noqa: E402

from _torch_matrix_task import (CELLS, CLI_ARGS, ROUNDS,  # noqa: E402
                                port_trainer)


def dump(out, tag, tr):
    rank = CTX.process_id
    arrays = {"params": tr.flat.numpy()}
    for k, v in tr.server_state.items():
        arrays[f"state_{k}"] = v.numpy()
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), **arrays)
    meta = {"history": [asdict(r) for r in tr.history],
            "schedule": [np.asarray(s).tolist()
                         for s in tr.state().schedule],
            "rows": list(tr._rows),
            "collectives": [[name for name, _ in r]
                            for r in tr.collective_log]}
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    assert CTX is not None and CTX.num_processes == 2, CTX
    for cell in CELLS:
        for prefetch in (True, False):
            with port_trainer(cell, shard_clients=True,
                              prefetch=prefetch) as tr:
                tr.run()
            dump(args.out, f"{cell}_prefetch{int(prefetch)}", tr)
    # cut at round 2: rank 0 writes, the barrier makes it visible to all
    ckpt = os.path.join(args.out, "ckpt2")
    with port_trainer("feddpc", shard_clients=True) as tr:
        tr.run_round(0)
        tr.run_round(1)
        path = tr.save(ckpt)
        assert os.path.isdir(path), path
        for t in range(2, ROUNDS):
            tr.run_round(t)
    dump(args.out, "cut", tr)
    # a single-process checkpoint, resumed on two ranks
    tr = port_trainer("feddpc", shard_clients=True)
    tr.restore(os.path.join(args.out, "ckpt1"))
    with tr:
        tr.run()
    dump(args.out, "resumed2", tr)
    # the training CLI, on the job this rank has joined
    from repro_torch.launch import train
    train.main(CLI_ARGS + ["--device", "cpu", "--shard-clients", "--out",
                           os.path.join(args.out, "cli.json")])
    print("TORCH_MULTIHOST_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
