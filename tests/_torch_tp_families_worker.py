"""One rank of the port's tensor-parallel check of the last three
families (tests/test_torch_tp_families.py), spawned on gloo by
launch/distributed.spawn_local in a job of PAIR or QUAD ranks. Imports
neither JAX nor the reference; importing it joins no job (the test
process reads its constants and builders).

Every rank of a job of M ranks runs STEPS SGD steps of
launch/steps.make_train_step over the job as one model group for each
configuration of STEP_CASES — DeepSeek-V2 SMOKE (MLA with MoE, and with
dense MLPs), Jamba-1.5 SMOKE (the hybrid: Mamba, GQA on 2 KV heads, MoE),
Falcon-Mamba SMOKE and Whisper-base SMOKE's encoder-decoder — on the
reference's init, and dumps its shard, the gathered params and the
losses. The pair then runs the training CLI's LM task on (1 x 2) for
each of TRAINER_ARCHS (FedDPC, K = 2) and dumps, per run: the gathered
params and server state, its own shards, the history, its place on the
mesh, its collectives and how often each FedDPC kernel's wrapper was
called.
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

SEED = 0
PAIR, QUAD = 2, 4
STEP_LR, STEP_B, STEP_S, STEPS = 0.01, 2, 16, 2
# case -> (arch, config overrides)
STEP_CASES = {"deepseek": ("deepseek-v2-236b", {}),
              "mla": ("deepseek-v2-236b", {"moe": False}),
              "jamba": ("jamba-1.5-large-398b", {}),
              "falcon_mamba": ("falcon-mamba-7b", {}),
              "whisper": ("whisper-base", {})}
TRAINER_ARCHS = ("jamba-1.5-large-398b", "deepseek-v2-236b")
CLIENTS, SEQ, BATCH, ROUNDS, K = 6, 17, 2, 2, 2
ETA_L, ETA_G = 0.05, 0.05

CALLS = collections.Counter()


def case_config(case, get_config):
    """The SMOKE config of a step case, from ``get_config`` (either
    package's)."""
    arch, more = STEP_CASES[case]
    return get_config(arch, smoke=True).with_(**more)


def step_batch(cfg):
    """make_train_step's batch: tokens and labels (a few -100), and an
    encoder-decoder's frames, from a numpy seed."""
    rng = np.random.RandomState(7)
    toks = rng.randint(0, cfg.vocab_size, (STEP_B, STEP_S + 1)
                       ).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(STEP_B, cfg.encoder_seq_len,
                                    cfg.d_model).astype(np.float32)
    return batch


def lm_args(arch):
    """The CLI arguments build_lm_task reads (both packages')."""
    return SimpleNamespace(model=arch, clients=CLIENTS, seq_len=SEQ,
                           seed=SEED, alpha=0.5, batch_size=BATCH)


def exec_kw(sharded=True):
    """The trainer runs' ExecConfig keywords; ``sharded=False`` the same
    run in one process."""
    kw = {"rounds": ROUNDS, "clients_per_round": K, "seed": SEED,
          "eval_every": 10 ** 9, "batch_size": BATCH}
    if sharded:
        kw.update(shard_clients=True, shard_model=PAIR)
    return kw


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _count_kernels():
    from repro_torch.kernels.feddpc_project import ops as k_ops
    for name in ("feddpc_dots", "feddpc_batched_epilogue"):
        fn = getattr(k_ops, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            CALLS[_name] += 1
            return _fn(*a, **kw)
        setattr(k_ops, name, wrapper)


def train_steps(out, rank, model):
    """STEPS steps of make_train_step over the job's ``model`` ranks for
    every step case; each rank dumps its shard, the gathered params and
    the losses."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.core import jax_prng
    from repro_torch.core.round import model_all_gather
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    for case in STEP_CASES:
        cfg = case_config(case, get_config)
        step = steps.make_train_step(cfg, lr=STEP_LR, remat="full",
                                     model_group=dist.group.WORLD)
        init = encdec.init_encdec if cfg.is_encoder_decoder else tf.init_lm
        params = init(cfg, jax_prng.PRNGKey(SEED), torch.float32)
        shard = step.shards.scatter(bridge.layout_of(params).flatten(params),
                                    rank)
        batch, losses = _t(step_batch(cfg)), []
        for _ in range(STEPS):
            shard, loss = step(shard, batch)
            losses.append(float(loss))
        full = model_all_gather(shard, dist.group.WORLD, step.shards)
        np.savez(os.path.join(out, f"step_{case}{model}_r{rank}.npz"),
                 shard=shard.numpy(), params=full.numpy(),
                 losses=np.asarray(losses))


def trainer(arch, sharded=True, **more):
    """The port's trainer of the LM task of ``arch`` on the CPU."""
    from repro_torch.core import api
    from repro_torch.launch import train
    cfg = api.ExecConfig(**exec_kw(sharded), **more)
    params, loss_fn, source, _ = train.build_lm_task(lm_args(arch), cfg,
                                                     "cpu")
    return api.FederatedTrainer(
        loss_fn, params, CLIENTS, source, cfg,
        algo=api.AlgoConfig(name="feddpc", eta_l=ETA_L, eta_g=ETA_G),
        device="cpu")


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


def main():
    from repro_torch.launch import distributed
    ctx = distributed.maybe_initialize()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ranks, rank = ctx.num_processes, ctx.process_id
    assert ranks in (PAIR, QUAD), ctx
    _count_kernels()
    train_steps(args.out, rank, ranks)
    if ranks == PAIR:
        for arch in TRAINER_ARCHS:
            CALLS.clear()
            with trainer(arch) as tr:
                tr.run()
            dump(args.out, arch, rank, tr)
    print("TORCH_TP_FAMILIES_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
