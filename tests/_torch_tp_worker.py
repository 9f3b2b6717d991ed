"""One rank of the port's tensor-parallel check (tests/
test_torch_tensor_parallel.py), spawned on gloo by
launch/distributed.spawn_local in a job of PAIR or QUAD ranks. Imports
neither JAX nor the reference; importing it joins no job (the test
process reads its constants and builders).

The task is the training CLI's LM task (launch/train.build_lm_task) on
StarCoder2 SMOKE — 2 layers, d_model 256, 4 heads on 2 KV heads, vocab
512 — with FedDPC at lam = 1. The pair runs the (1 x 2) cells and
make_train_step at M = 2; the quad the (2 x 2) and (1 x 4) cells and
make_train_step at M = 4, where the 2 KV heads do not split; both the
dense families' SMOKE gradients on the job's group. Each rank
dumps, per run: the gathered params and server state, its own shards,
the history, its place on the mesh and its collectives, and how often
each FedDPC kernel's wrapper (and int8_sr_quantize) was called.
"""
import argparse
import collections
import json
import os
import sys
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import torch

ARCH = "starcoder2-3b"
SEED = 0
CLIENTS, SEQ, BATCH, ROUNDS = 6, 17, 2, 2
ETA_L, ETA_G = 0.05, 0.05
STEP_LR, STEP_B, STEP_S, STEPS = 0.01, 4, 16, 2
PAIR, QUAD = 2, 4
# trainer cell -> (job size, model shards, K, ExecConfig overrides)
ASYNC = {"async_buffer": True, "buffer_size": 2, "async_concurrency": 2,
         "codec": "int8", "codec_ef": True}
# K = 2 everywhere, so the sync cells share their one-process runs: on
# (2 x 2) a client slice of 1 row, on (1 x 4) 2 rows, on 2 and 4 model
# ranks
CELLS = {"tp:1x2": (PAIR, 2, 2, {}),
         "tp:2x2": (QUAD, 2, 2, {}),
         "tp:1x4": (QUAD, 4, 2, {}),
         "tp:async_int8_ef:1x2": (PAIR, 2, 2, ASYNC)}
CUT_CELL = "tp:1x2"               # cut after round 1, resumed in one process
FL_SILOS, FL_STEPS = 2, 2         # make_fl_round_step's batches on (1 x 2)

CALLS = collections.Counter()


def lm_args():
    """The CLI arguments build_lm_task reads (both packages')."""
    return SimpleNamespace(model=ARCH, clients=CLIENTS, seq_len=SEQ,
                           seed=SEED, alpha=0.5, batch_size=BATCH)


def exec_kw(cell, sharded=True):
    """A cell's ExecConfig keywords; ``sharded=False`` the same run in one
    process."""
    _, model, k, more = CELLS[cell]
    kw = {"rounds": ROUNDS, "clients_per_round": k, "seed": SEED,
          "eval_every": 10 ** 9, "batch_size": BATCH, **more}
    if sharded:
        kw.update(shard_clients=True, shard_model=model)
    return kw


def runtime(cell):
    from repro_torch.core.runtime import ExponentialRuntime
    return (ExponentialRuntime(mean=1.0) if CELLS[cell][3].get(
        "async_buffer") else None)


def trainer(cell, sharded=True, **more):
    """The port's trainer of a cell on the CPU."""
    from repro_torch.core import api
    from repro_torch.launch import train
    cfg = api.ExecConfig(**exec_kw(cell, sharded), **more)
    params, loss_fn, source, _ = train.build_lm_task(lm_args(), cfg, "cpu")
    return api.FederatedTrainer(
        loss_fn, params, CLIENTS, source, cfg,
        algo=api.AlgoConfig(name="feddpc", eta_l=ETA_L, eta_g=ETA_G),
        runtime=runtime(cell), device="cpu")


def step_batch():
    """make_train_step's batch: tokens and labels (a few -100)."""
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 512, (STEP_B, STEP_S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    return {"tokens": toks[:, :-1], "labels": labels}


def fl_batches():
    """make_fl_round_step's (silos, steps, B, S) batches, all valid."""
    rng = np.random.RandomState(11)
    toks = rng.randint(0, 512, (FL_SILOS, FL_STEPS, BATCH, SEQ)
                       ).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _count_kernels():
    from repro_torch.kernels.feddpc_project import ops as k_ops
    from repro_torch.kernels.int8_sr import ops as sr_ops
    for mod, names in ((k_ops, ("feddpc_dots", "feddpc_guard_dots",
                                "feddpc_batched_epilogue",
                                "feddpc_dequant_batched_epilogue")),
                       (sr_ops, ("int8_sr_quantize",))):
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*a, _fn=fn, _name=name, **kw):
                CALLS[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, wrapper)


def dump(out, tag, rank, tr):
    arrays = {"params": tr.full_params().numpy(),
              "shard_params": tr.flat.numpy()}
    for k, v in tr.full_state().items():
        arrays[f"state_{k}"] = v.numpy()
    for k, v in tr.server_state.items():
        arrays[f"shard_state_{k}"] = v.numpy()
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), **arrays)
    meta = {"history": [asdict(r) for r in tr.history],
            "shard": tr.shard_info(), "calls": dict(CALLS),
            "collectives": [[name for name, _ in r]
                            for r in tr.collective_log]}
    with open(os.path.join(out, f"{tag}_r{rank}.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def train_steps(out, rank, model):
    """STEPS steps of make_train_step(remat="full") over a model group of
    ``model`` ranks on the reference's init; every rank dumps its shard
    and the losses, and the gathered params."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.core import jax_prng
    from repro_torch.core.round import model_all_gather
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = get_config(ARCH, smoke=True)
    world = dist.get_world_size()
    groups = [dist.new_group(list(range(g, g + model)))
              for g in range(0, world, model)]
    group = groups[rank // model]
    step = steps.make_train_step(cfg, lr=STEP_LR, remat="full",
                                 model_group=group)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(SEED), torch.float32)
    m = rank % model
    shard = step.shards.scatter(bridge.layout_of(params).flatten(params), m)
    batch, losses = _t(step_batch()), []
    for _ in range(STEPS):
        shard, loss = step(shard, batch)
        losses.append(float(loss))
    full = model_all_gather(shard, group, step.shards)
    np.savez(os.path.join(out, f"step{model}_r{rank}.npz"),
             shard=shard.numpy(), params=full.numpy(),
             losses=np.asarray(losses))


DENSE = ("starcoder2-3b", "phi4-mini-3.8b", "minitron-8b",
         "command-r-35b", "llava-next-mistral-7b")


def dense_family_grads(out, rank, model):
    """Each dense family's SMOKE loss and cohort gradient (vmap over 2
    rows, as the trainer takes it) on the model group of the whole job,
    against the same rank's one-process gradient restricted to its
    shard: tied embeddings (Phi-4-mini, Command-R), SwiGLU, squared ReLU
    (Minitron), RMSNorm, the VLM's patch prefix (LLaVA)."""
    import torch.distributed as dist
    from torch.func import grad_and_value, vmap
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.core import jax_prng
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.layout import ShardLayout, TPView
    from repro_torch.sharding.tensor_parallel import TPContext
    arrays = {}
    for arch in DENSE:
        cfg = get_config(arch, smoke=True)
        params = tf.init_lm(cfg, jax_prng.PRNGKey(SEED), torch.float32)
        layout = bridge.layout_of(params)
        shards = ShardLayout.from_sizes(layout, {"clients": 1,
                                                 "model": model})
        tp = TPContext.of(dist.group.WORLD)
        view = TPView(shards, rank, cfg.resolved_head_dim, tp)
        rng = np.random.RandomState(3)
        toks = rng.randint(0, cfg.vocab_size, (2, 2, 13)).astype(np.int64)
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.modality == "vision":
            batch["patch_embeds"] = (0.02 * rng.randn(
                2, 2, cfg.num_patches, cfg.d_model)).astype(np.float32)
        batch = _t(batch)
        w = layout.flatten(params).expand(2, -1) + torch.from_numpy(
            0.01 * rng.randn(2, layout.size).astype(np.float32))
        whole = vmap(grad_and_value(
            lambda v, b: tf.loss_fn(cfg, layout.unflatten(v), b)))(w, batch)
        part = vmap(grad_and_value(
            lambda v, b: tf.loss_fn(cfg, view.unflatten(v), b, tp=tp)))(
                shards.scatter(w, rank), batch)
        arrays[f"{arch}_grad"] = part[0].numpy()
        arrays[f"{arch}_want_grad"] = shards.scatter(whole[0], rank).numpy()
        arrays[f"{arch}_loss"] = part[1].numpy()
        arrays[f"{arch}_want_loss"] = whole[1].numpy()
    np.savez(os.path.join(out, f"dense{model}_r{rank}.npz"), **arrays)


def fl_round_steps(out, rank):
    """Two rounds of make_fl_round_step on the (1 x 2) mesh: the slice's
    silos on both model ranks, params and delta_prev their shards."""
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.core import jax_prng
    from repro_torch.core.round import make_fl_round_step, model_all_gather
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.layout import ShardLayout
    cfg = get_config(ARCH, smoke=True)
    mesh = make_cohort_mesh(model=2)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(SEED), torch.float32)
    layout = bridge.layout_of(params)
    shards = ShardLayout.from_mesh(layout, mesh)
    step = make_fl_round_step(tf.LMLoss(cfg), layout, ETA_L, ETA_G, 1.0,
                              "feddpc", mesh=mesh, params_template=params)
    p = shards.scatter(layout.flatten(params), rank)
    dp = torch.zeros_like(p)
    group = mesh["model"].get_group()
    arrays = {}
    for t in range(2):
        p, dp, metrics = step(p, dp, _t(fl_batches()))
        arrays[f"{t}_params"] = model_all_gather(p, group, shards).numpy()
        arrays[f"{t}_dp"] = model_all_gather(dp, group, shards).numpy()
        for k, v in metrics.items():
            arrays[f"{t}_m_{k}"] = np.asarray(float(v))
    np.savez(os.path.join(out, f"fl_round_r{rank}.npz"), **arrays)


def main():
    from repro_torch.launch import distributed
    ctx = distributed.maybe_initialize()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ranks, rank = ctx.num_processes, ctx.process_id
    assert ranks in (PAIR, QUAD), ctx
    _count_kernels()
    train_steps(args.out, rank, 2 if ranks == PAIR else 4)
    dense_family_grads(args.out, rank, ranks)
    for cell, (job, _, _, _) in CELLS.items():
        if job != ranks:
            continue
        CALLS.clear()
        with trainer(cell) as tr:
            tr.run()
        dump(args.out, cell, rank, tr)
    if ranks == PAIR:
        CALLS.clear()
        with trainer(CUT_CELL) as tr:
            tr.run_round(0)
            tr.save(os.path.join(args.out, "ckpt_tp"))
        fl_round_steps(args.out, rank)
    print("TORCH_TP_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
