"""Federated pretraining of a ~100M-parameter GPT-style LM with FedDPC
(counterpart of the reference's examples/federated_llm_pretraining.py).

  PYTHONPATH=src python -m repro_torch.examples.federated_llm_pretraining
  PYTHONPATH=src python -m repro_torch.examples.federated_llm_pretraining \\
      --tiny --device cpu                       # CI-sized

The beyond-paper scenario the framework exists for: cross-silo federated
LLM training where each client is a data silo with a topic-skewed corpus
(Dirichlet-partitioned Zipf LM streams). The model is the StarCoder2
family config scaled to ~100M params (12 layers, d_model 768, 12 heads
on 4 KV, vocab 16,384); the server runs FedDPC (projection + adaptive
scaling). ``--ckpt-dir DIR`` checkpoints the full TrainerState every 25
rounds (the reference's default directory is under /tmp; the port writes
none unless asked). The initial params are the reference's draws from
PRNGKey(0) (core/jax_prng.py: ~20 s of numpy for the ~100M model), so
the printed losses are the reference example's.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import jax_prng
from repro_torch.core.api import (AlgoConfig, ExecConfig, FederatedTrainer,
                                  resolve_device)
from repro_torch.core.baselines import FedDPCHyper
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.models import transformer as tf


@dataclass
class Task:
    """Everything a run of the example needs."""
    cfg: object                 # the ArchConfig
    params: dict                # the reference's tree and init
    loss_fn: Callable
    batch_fn: Callable          # (client, round) -> [batch]
    eval_fn: Callable           # params -> -holdout loss
    clients: int
    cohort: int
    rounds: int
    eta: float
    sizes: list                 # documents a client


def build(tiny: bool, rounds=None, device="cuda") -> Task:
    """The example's model, data, init and eval, as the reference builds
    them (the holdout batch on ``device``)."""
    if tiny:
        cfg = get_config("starcoder2-3b", smoke=True)
        rounds = rounds or 8
        clients, part, seq, bsz = 8, 4, 64, 4
        docs = 256
        eta = 0.01      # the smoke config diverges at the full-run LR
    else:
        # ~100M params: 12 layers x d_model 768, vocab 16384
        cfg = get_config("starcoder2-3b").with_(
            num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            d_ff=3072, vocab_size=16384, max_seq_len=512)
        rounds = rounds or 200
        clients, part, seq, bsz = 20, 5, 256, 8
        docs = 2000
        eta = 0.05
    params = tf.init_lm(cfg, jax_prng.PRNGKey(0), torch.float32)
    tokens, topics = make_lm_dataset(docs, seq + 1, cfg.vocab_size, seed=0)
    parts = dirichlet_partition(topics, clients, alpha=0.3, seed=0,
                                min_size=1)

    # a dense decoder's loss: on a (clients, model) mesh it trains
    # tensor-parallel (transformer.LMLoss)
    loss_fn = tf.LMLoss(cfg)

    def batch_fn(c, t):
        idx = parts[c]
        rng = np.random.RandomState(hash((c, t)) % (2 ** 31))
        sel = idx[rng.permutation(len(idx))]
        sel = np.concatenate([sel] * (bsz // max(len(sel), 1) + 1))[:bsz]
        tk = tokens[sel]
        return [{"tokens": tk[:, :-1], "labels": tk[:, 1:]}]

    holdout = torch.from_numpy(tokens[: 4 * bsz]).to(device)
    ho_batch = {"tokens": holdout[:, :-1], "labels": holdout[:, 1:]}

    def eval_fn(p):
        with torch.no_grad():
            return -loss_fn(p, ho_batch)    # "accuracy" slot = -holdout loss

    return Task(cfg, params, loss_fn, batch_fn, eval_fn, clients, part,
                rounds, eta, [len(p) for p in parts])


def main(argv=None):
    """Runs the example; returns the trainer's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the TrainerState every 25 rounds here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    task = build(args.tiny, args.rounds, device)
    cfg, rounds = task.cfg, task.rounds
    n = sum(t.numel() for t in bridge.tree_leaves(task.params))
    print(f"model: {n/1e6:.1f}M params, {cfg.num_layers}L d={cfg.d_model}")
    print(f"{task.clients} clients, doc counts: min={min(task.sizes)} "
          f"max={max(task.sizes)}")

    algo = AlgoConfig(name="feddpc", eta_l=task.eta, eta_g=task.eta,
                      hyper=FedDPCHyper(lam=1.0))
    exec_cfg = ExecConfig(rounds=rounds, clients_per_round=task.cohort,
                          eval_every=10,
                          # this example prints the holdout NLL inline with
                          # its round, so keep eval on the blocking path
                          async_eval=False)
    t0 = time.time()
    with FederatedTrainer(task.loss_fn, task.params, task.clients,
                          task.batch_fn, exec_cfg, task.eval_fn, algo=algo,
                          device=device) as tr:
        for t in range(rounds):
            rec = tr.run_round(t)
            if t % 10 == 0 or t == rounds - 1:
                ho = f"  holdout_nll={-rec.test_accuracy:.4f}" \
                    if rec.test_accuracy is not None else ""
                print(f"round {t:4d} loss={rec.train_loss:.4f}{ho} "
                      f"({rec.seconds:.1f}s)")
            if args.ckpt_dir and t and t % 25 == 0:
                # full TrainerState: `FederatedTrainer.resume(ckpt_dir,
                # ...)` continues this run exactly where it stopped
                tr.save(args.ckpt_dir)
        print(f"done in {time.time()-t0:.0f}s; "
              f"loss {tr.history[0].train_loss:.3f} -> "
              f"{tr.history[-1].train_loss:.3f}")
        if not tr.history[-1].train_loss < tr.history[0].train_loss:
            raise RuntimeError("the training loss did not fall")
        return tr.history


if __name__ == "__main__":
    main()
