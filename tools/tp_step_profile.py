"""Where a tensor-parallel train step's time goes: chip_smoke.py's
tp_train step (StarCoder2-3B at full width, f32, B = 2 x 1,024,
make_train_step(remat="full")) profiled with torch.profiler — once in
one process, then on every rank of tp_layout's job (2 gloo ranks on one
card, 4 NCCL ranks on four) — after one warm step. Each line gives the
step's wall seconds, the device's busy ms, and the ops with the most
device time and the most host time (self), with their calls.

Needs the card:

    python3 tools/tp_step_profile.py
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
TOP = 15


def _profiled_step(step, state, batch) -> dict:
    """One warm step, then one step under the profiler: its wall seconds
    and the top ops by device and by host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        state, loss = step(state, batch)
        float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    avg = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))

    def top(key):
        rows = sorted(avg, key=key, reverse=True)[:TOP]
        return [{"op": e.key, "calls": e.count,
                 "device_ms": dev(e) / 1e3,
                 "host_ms": e.self_cpu_time_total / 1e3} for e in rows]
    return {"wall_s": wall, "device_busy_ms": sum(dev(e) for e in avg) / 1e3,
            "host_self_ms": sum(e.self_cpu_time_total for e in avg) / 1e3,
            "top_device": top(dev),
            "top_host": top(lambda e: e.self_cpu_time_total)}


def worker(out: str) -> int:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    ctx = cs.distributed.maybe_initialize()
    cfg = cs.get_config(cs.LM_TRAIN_ARCH)
    params, batch = cs._tp_lm_params(cfg, torch.Generator(
        device="cuda").manual_seed(0))
    step = cs.lm_steps.make_train_step(cfg, lr=cs.LM_TRAIN_LR, remat="full",
                                       model_group=dist.group.WORLD)
    shard = step.shards.scatter(
        torch.cat([p.reshape(-1) for p in cs.reference_pieces(cfg, params)]),
        ctx.process_id)
    del params
    torch.cuda.empty_cache()
    line = {"tool": "tp_step_profile", "rank": ctx.process_id,
            "ranks": ctx.num_processes, "backend": ctx.backend,
            **_profiled_step(step, shard, batch)}
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as fh:
        json.dump(line, fh)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == WORKER:
        return worker(sys.argv[2])
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("tp_step_profile: CUDA is not available; this tool needs a "
              "card", file=sys.stderr)
        return 1
    cfg = cs.get_config(cs.LM_TRAIN_ARCH)
    params, batch = cs._tp_lm_params(cfg, torch.Generator(
        device="cuda").manual_seed(0))
    step = cs.lm_steps.make_train_step(cfg, lr=cs.LM_TRAIN_LR, remat="full")
    print(json.dumps({"tool": "tp_step_profile", "rank": None, "ranks": 1,
                      **_profiled_step(step, params, batch)}), flush=True)
    del params, step
    torch.cuda.empty_cache()
    ranks, backend = cs.tp_layout(torch.cuda.device_count())
    with tempfile.TemporaryDirectory(prefix="tp_profile_") as out:
        env = ({"NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME",
                                                     "lo")}
               if backend == "nccl" else {})
        cs.distributed.spawn_local(
            [sys.executable, os.path.abspath(__file__), WORKER, out], ranks,
            backend=backend, local_devices=1 if backend == "gloo" else None,
            env=env, timeout_s=900)
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                print(fh.read(), flush=True)
    print(json.dumps({"tool": "tp_step_profile",
                      "card": cs._smi("name,power.limit")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
