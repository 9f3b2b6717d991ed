"""Both routes of local training on the model axis, side by side on the
same card: chip_smoke.py's model_axis run (f) — the ~101M federated LM
example (FedDPC, lam 1, K = 5 of 20 clients, MA_LM_ROUNDS rounds) on a
(1 x ranks) mesh — trained tensor-parallel (the example's
transformer.LMLoss: every model rank trains every row on its shard) and
with the row split (the same loss behind a plain function: each model
rank trains its rows at full width, gathers the params first and hands
the deltas' columns over in an all-to-all). The runs go in turns —
rows, tensor-parallel, tensor-parallel, rows — in one job of ma_layout's
ranks (2 gloo ranks on one card). Then three more tensor-parallel runs
count the FedDPC kernels a rank launches on that route: sync int8_sr,
async int8 with error feedback, and async f32 under the update guard.

Each rank prints per run chip_smoke._ma_line's fields: its route, N_m,
the bytes it holds at rest (with the round's delta stack), its peak
memory, each collective's ms a round and its seconds a round; the
parent adds the card's name and power limit. Needs the card:

    python3 tools/tp_route_report.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

WORKER = "--worker"
TURNS = ("rows", "tensor_parallel", "tensor_parallel", "rows")
# then the FedDPC kernels' launches on the tensor-parallel route, a line
# each: label -> ExecConfig overrides (the async runs: B = 5, 2 waves in
# flight, exponential latencies)
ASYNC = {"async_buffer": True, "buffer_size": 5, "async_concurrency": 2}
LAUNCH_RUNS = {"tp_int8_sr": {"codec": "int8_sr"},
               "tp_async_int8_ef": {**ASYNC, "codec": "int8",
                                    "codec_ef": True},
               "tp_async_guard": {**ASYNC, "guard": True}}


def worker(out: str) -> int:
    import gc
    import torch
    import chip_smoke as cs
    ctx = cs.distributed.maybe_initialize()
    lines = []
    runs = [(route, {}) for route in TURNS] + [
        ("tensor_parallel", kw) for kw in LAUNCH_RUNS.values()]
    labels = list(TURNS) + list(LAUNCH_RUNS)
    for i, ((route, kw), label) in enumerate(zip(runs, labels)):
        task = cs.llm_example.build(tiny=False, rounds=cs.MA_LM_ROUNDS,
                                    device="cuda")
        loss_fn = task.loss_fn
        if route == "rows":
            def loss_fn(p, batch, _lm=task.loss_fn):
                return _lm(p, batch)
        cs._ma_reset()
        with cs.FederatedTrainer(
                loss_fn, task.params, task.clients, task.batch_fn,
                cs.ExecConfig(rounds=cs.MA_LM_ROUNDS,
                              clients_per_round=task.cohort,
                              eval_every=10 ** 9, shard_clients=True,
                              shard_model=ctx.num_processes, **kw), None,
                algo=cs.AlgoConfig(name="feddpc", eta_l=task.eta,
                                   eta_g=task.eta,
                                   hyper=cs.FedDPCHyper(lam=1.0)),
                runtime=(cs.ExponentialRuntime(mean=1.0)
                         if kw.get("async_buffer") else None),
                device="cuda") as tr:
            tr.run()
        line = cs._ma_line("f", tr, ctx, cs.MA_LM_ROUNDS)
        line.update(tool="tp_route_report", turn=i, label=label)
        assert line["route"] == route, (line["route"], route)
        lines.append(line)
        del tr, task
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(lines, fh)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == WORKER:
        return worker(sys.argv[2])
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("tp_route_report: CUDA is not available; this tool needs a "
              "card", file=sys.stderr)
        return 1
    ranks, backend = cs.ma_layout(torch.cuda.device_count())
    tic = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp_route_") as out:
        env = ({"NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME",
                                                     "lo")}
               if backend == "nccl" else {})
        cs.distributed.spawn_local(
            [sys.executable, os.path.abspath(__file__), WORKER, out], ranks,
            backend=backend, local_devices=1 if backend == "gloo" else None,
            env=env, timeout_s=900)
        lines = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                lines += json.load(fh)
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"tool": "tp_route_report", "ranks": ranks,
                      "backend": backend,
                      "card": cs._smi("name,power.limit"),
                      "seconds": time.perf_counter() - tic}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
