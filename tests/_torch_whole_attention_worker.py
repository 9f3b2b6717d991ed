"""One rank of the port's check of attention whole on every rank
(tests/test_torch_tp_whole_attention.py), spawned on gloo by
launch/distributed.spawn_local in a job of RANKS ranks: a model axis of
3 over SMOKE configs with 4 query heads (sharding/layout.
attention_whole: wq/wk/wv/wo WHOLE, every rank every head), their MLP
width set to a multiple of 3 so that it still splits. Imports neither
JAX nor the reference; importing it joins no job.

For each case every rank runs STEPS SGD steps of
launch/steps.make_train_step over the job as one model group on the
reference's init and dumps the losses and the gathered params; then a
prefill and EXTRA decode steps of make_prefill_step / make_decode_step
over the group (the tp_serve worker's inputs), dumping the logits, the
gathered states and its own caches' KV heads. Last, the (data, model)
form of the step (make_train_step(model_group=, data_group=)): the job as
3 data ranks of one model rank each, on DP_ROWS rows with every label
valid, each rank its third of them, dumping its params and losses.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

RANKS = 3
SEED, STEP_LR, STEPS = 0, 0.01, 2
D_FF = 384                 # a multiple of RANKS: the MLP splits
CASES = {"starcoder2": "starcoder2-3b", "whisper": "whisper-base"}
DP_ROWS = 6                # the data-parallel check's batch: 2 rows a rank


def dp_batch(cfg):
    """DP_ROWS rows of tokens and labels, every label valid (so the mean
    of the ranks' means is the whole batch's mean)."""
    rng = np.random.RandomState(9)
    toks = rng.randint(0, cfg.vocab_size, (DP_ROWS, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def case_config(case, get_config):
    """A SMOKE config with 4 heads and the MLP width D_FF (either
    package's ``get_config``)."""
    return get_config(CASES[case], smoke=True).with_(d_ff=D_FF)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def train(cfg, rank, out, tag):
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.core import jax_prng
    from repro_torch.core.round import model_all_gather
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    import _torch_tp_families_worker as fam
    step = steps.make_train_step(cfg, lr=STEP_LR, remat="full",
                                 model_group=dist.group.WORLD)
    init = encdec.init_encdec if cfg.is_encoder_decoder else tf.init_lm
    params = init(cfg, jax_prng.PRNGKey(SEED), torch.float32)
    shard = step.shards.scatter(bridge.layout_of(params).flatten(params),
                                rank)
    batch = {k: _t(v) for k, v in fam.step_batch(cfg).items()}
    losses = []
    for _ in range(STEPS):
        shard, loss = step(shard, batch)
        losses.append(float(loss))
    full = model_all_gather(shard, dist.group.WORLD, step.shards)
    np.savez(os.path.join(out, f"train_{tag}_r{rank}.npz"),
             params=full.numpy(), losses=np.asarray(losses))
    return step.view.classes


def serve(cfg, rank, out, tag):
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.configs import shapes
    from repro_torch.core import jax_prng
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    import _torch_tp_serve_worker as ts
    kw = {"model_group": dist.group.WORLD}
    prefill = steps.make_prefill_step(cfg, shapes.SHAPES["prefill_32k"],
                                      **kw)
    decode = steps.make_decode_step(cfg, shapes.SHAPES["decode_32k"], **kw)
    init = encdec.init_encdec if cfg.is_encoder_decoder else tf.init_lm
    tree = steps.serving_tree(cfg, init(cfg, jax_prng.PRNGKey(SEED),
                                        torch.float32))
    leaves = bridge.tree_leaves(tree)
    srv = prefill.serving
    with torch.inference_mode():
        params = srv.params(lambda i: leaves[i])
        data = ts.inputs(cfg)
        states = srv.init_states(ts.B, ts.capacity(cfg), torch.float32,
                                 "cpu")
        layers = states["decoder"] if cfg.is_encoder_decoder else states
        kv_heads = sorted({int(c["k"].shape[2]) for c in layers})
        if cfg.is_encoder_decoder:
            states, logits = prefill(params, states, _t(data["frames"]),
                                     _t(data["tokens"]))
        else:
            states, logits = prefill(params, states, _t(data["tokens"]))
        arrays = {"logits_0": logits.numpy(),
                  **ts.flat_states(srv.gather_states(states), "prefill")}
        for i in range(ts.EXTRA):
            pos = np.full((ts.B, 1), ts.PROMPT + i, np.int32)
            states, logits = decode(params, states, _t(data["forced"][i]),
                                    _t(pos))
            arrays[f"logits_{i + 1}"] = logits.numpy()
        arrays.update(ts.flat_states(srv.gather_states(states), "last"))
    np.savez(os.path.join(out, f"serve_{tag}_r{rank}.npz"), **arrays)
    return kv_heads


def train_data_parallel(cfg, rank, out):
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.core import jax_prng
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    ones = [dist.new_group([r]) for r in range(RANKS)]
    step = steps.make_train_step(cfg, lr=STEP_LR, remat="full",
                                 model_group=ones[rank],
                                 data_group=dist.group.WORLD)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(SEED), torch.float32)
    shard = step.shards.scatter(bridge.layout_of(params).flatten(params), 0)
    batch = {k: _t(v) for k, v in dp_batch(cfg).items()}
    losses = []
    for _ in range(STEPS):
        shard, loss = step(shard, batch)
        losses.append(float(loss))
    np.savez(os.path.join(out, f"dp_r{rank}.npz"), params=shard.numpy(),
             losses=np.asarray(losses))


def main():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import distributed
    ctx = distributed.maybe_initialize()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    assert ctx.num_processes == RANKS, ctx
    rank = ctx.process_id
    meta = {}
    for case in CASES:
        cfg = case_config(case, get_config)
        classes = train(cfg, rank, args.out, case)
        meta[case] = {"classes": list(classes),
                      "kv_heads": serve(cfg, rank, args.out, case)}
    with open(os.path.join(args.out, f"meta_r{rank}.json"), "w") as fh:
        json.dump(meta, fh)
    train_data_parallel(case_config("starcoder2", get_config), rank,
                        args.out)
    print("TORCH_WHOLE_ATTENTION_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
