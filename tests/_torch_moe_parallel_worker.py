"""One rank of the port's MoE-on-the-mesh check (tests/
test_torch_moe_parallel.py), spawned on gloo by
launch/distributed.spawn_local in a job of PAIR or QUAD ranks. Imports
neither JAX nor the reference; importing it joins no job (the test
process reads its constants and builders).

Kimi-K2 SMOKE (2 layers: 1 dense, 1 MoE of 4 experts + 1 shared, top-2,
moe_d_ff 128; GQA 4 on 2 heads, d_model 256, vocab 512), the reference's
init from PRNGKey(SEED). The pair runs, on (1 x 2): the tensor-parallel
MoE layer, make_train_step over the model group (at capacity factor 8),
and a federated FedDPC run on the trainer's tensor-parallel route. The
quad runs the tensor-parallel layer at M = 4 and, on a (2 x 2)
make_debug_mesh, the expert-parallel layer (moe_forward_ep) and train
step at capacity factor 8. Each rank dumps what it computed, and its place.
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

ARCH = "kimi-k2-1t-a32b"
SEED = 0
PAIR, QUAD = 2, 4
# the layer: B x S tokens at the config's capacity factor (1.25), where
# the router's skew drops assignments
LAYER_B, LAYER_S = 4, 16
EP_CF = 8.0                      # the reference's EP-vs-GShard setting
EP_B, EP_S = 4, 8                # the reference's four-device case
STEP_LR, STEP_B, STEP_S, STEPS = 0.01, 4, 16, 2
CLIENTS, SEQ, BATCH, ROUNDS, K = 6, 17, 2, 2, 4
ETA_L, ETA_G = 0.05, 0.05

CALLS = collections.Counter()


def layer_inputs(b, s, d):
    """The layer's input (B, S, D) and the output's random projection
    (the layer's loss is sum(out * proj) + aux). The input's offset of
    0.5 skews the router (at LAYER_B x LAYER_S, 45 of the 128
    assignments go to one expert, whose capacity is 40)."""
    rng = np.random.RandomState(5)
    return (rng.randn(b, s, d).astype(np.float32) + np.float32(0.5),
            rng.randn(b, s, d).astype(np.float32))


def step_batch(b=STEP_B, s=STEP_S):
    """make_train_step's batch: tokens and labels (a few -100)."""
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 512, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    return {"tokens": toks[:, :-1], "labels": labels}


def lm_args():
    """The CLI arguments build_lm_task reads (both packages')."""
    return SimpleNamespace(model=ARCH, clients=CLIENTS, seq_len=SEQ,
                           seed=SEED, alpha=0.5, batch_size=BATCH)


def exec_kw(sharded=True):
    kw = {"rounds": ROUNDS, "clients_per_round": K, "seed": SEED,
          "eval_every": 10 ** 9, "batch_size": BATCH}
    if sharded:
        kw.update(shard_clients=True, shard_model=2)
    return kw


def trainer(sharded=True, device="cpu", **more):
    """The port's federated LM trainer on ``device``."""
    from repro_torch.core import api
    from repro_torch.launch import train
    cfg = api.ExecConfig(**exec_kw(sharded), **more)
    params, loss_fn, source, _ = train.build_lm_task(lm_args(), cfg, device)
    return api.FederatedTrainer(
        loss_fn, params, CLIENTS, source, cfg,
        algo=api.AlgoConfig(name="feddpc", eta_l=ETA_L, eta_g=ETA_G),
        device=device)


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


def layer_shards(cfg, model, data=1):
    """The MoE layer's tree {"mlp": init_moe from PRNGKey(SEED)} (its
    paths a decoder layer's, which the rules read), its flat layout and
    its shards: the cohort rules over ``model`` ranks, or the
    expert-parallel layout on (data, model)."""
    from repro_torch import bridge
    from repro_torch.core import jax_prng
    from repro_torch.models import moe
    from repro_torch.sharding.layout import ShardLayout
    p = {"mlp": moe.init_moe(jax_prng.PRNGKey(SEED), cfg, torch.float32)}
    layout = bridge.layout_of(p)
    if data > 1:
        shards = ShardLayout.for_experts(layout, data, model)
    else:
        shards = ShardLayout.from_sizes(layout, {"clients": 1,
                                                 "model": model})
    return layout.flatten(p), layout, shards


def tp_layer(out, rank, group, model, tag):
    """The tensor-parallel MoE layer of rank ``rank`` of a model group of
    ``model``: its output, aux and the gradient of sum(out * proj) + aux
    w.r.t. its shard, and its expert ids."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.sharding.layout import TPView
    from repro_torch.sharding.tensor_parallel import TPContext
    cfg = get_config(ARCH, smoke=True)
    flat, layout, shards = layer_shards(cfg, model)
    tp = TPContext.of(group)
    view = TPView(shards, tp.rank, cfg.resolved_head_dim, tp)
    x, proj = (torch.from_numpy(a) for a in layer_inputs(
        LAYER_B, LAYER_S, cfg.d_model))
    shard = shards.scatter(flat, tp.rank).requires_grad_(True)
    tree = view.unflatten(shard)["mlp"]
    y, aux = moe.moe_forward(cfg, tree, x, tp=tp)
    (grad,) = torch.autograd.grad((y * proj).sum() + aux, shard)
    with torch.no_grad():
        logits = x.reshape(1, -1, cfg.d_model) @ tree["router"]["w"]
        _, idx, _ = moe._route(cfg, logits)
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), out=y.detach().numpy(),
             aux=aux.detach().numpy(), grad=grad.numpy(),
             shard=shard.detach().numpy(), idx=idx.numpy(),
             classes=np.asarray(view.classes))


def ep_layer(out, rank, mesh):
    """moe_forward_ep on the (2 x 2) mesh at capacity factor EP_CF: this
    rank's rows of the (EP_B, EP_S) input and its output rows and aux."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe_ep
    from repro_torch.sharding.layout import TPView
    cfg = get_config(ARCH, smoke=True).with_(capacity_factor=EP_CF)
    d, m = mesh.get_coordinate()
    flat, layout, shards = layer_shards(cfg, 2, data=2)
    ep, tp = moe_ep.contexts(mesh)
    view = TPView(shards, m, cfg.resolved_head_dim, tp, rank=d * 2 + m)
    x, proj = layer_inputs(EP_B, EP_S, cfg.d_model)
    per = EP_B // 2
    x = torch.from_numpy(x[d * per:(d + 1) * per])
    shard = shards.scatter(flat, d * 2 + m)
    tree = view.unflatten(shard)["mlp"]
    y, aux = moe_ep.moe_forward_ep(cfg, tree, x, mesh=mesh)
    np.savez(os.path.join(out, f"ep_layer_r{rank}.npz"), out=y.numpy(),
             aux=aux.numpy(), coords=np.asarray([d, m]),
             expert_shape=np.asarray(tree["gate"].shape))


def train_steps(out, rank, tag, **step_kw):
    """STEPS steps of make_train_step(remat="full") from the reference's
    init at capacity factor EP_CF, over a model group (``model_group``,
    routing in 2 token groups: the aux of the expert-parallel form) or a
    (data, model) mesh (``moe_impl="ep"``): the losses and this rank's
    shard at the end."""
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.core import jax_prng
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = get_config(ARCH, smoke=True).with_(capacity_factor=EP_CF)
    if step_kw.get("moe_impl") != "ep":
        step_kw["moe_groups"] = 2
    step = steps.make_train_step(cfg, lr=STEP_LR, remat="full", **step_kw)
    params = tf.init_lm(cfg, jax_prng.PRNGKey(SEED), torch.float32)
    r = rank if step_kw.get("moe_impl") == "ep" else step.tp.rank
    shard = step.shards.scatter(bridge.layout_of(params).flatten(params), r)
    batch, losses = _t(step_batch()), []
    for _ in range(STEPS):
        shard, loss = step(shard, batch)
        losses.append(float(loss))
    np.savez(os.path.join(out, f"{tag}_r{rank}.npz"), shard=shard.numpy(),
             losses=np.asarray(losses))


def fed_rounds(out, rank):
    """The federated FedDPC run of Kimi-K2 SMOKE on (1 x 2): the trainer's
    tensor-parallel route."""
    CALLS.clear()
    with trainer() as tr:
        tr.run()
    np.savez(os.path.join(out, f"fed_r{rank}.npz"),
             params=tr.full_params().numpy(), shard=tr.flat.numpy(),
             **{f"state_{k}": v.numpy() for k, v in tr.full_state().items()})
    meta = {"history": [asdict(r) for r in tr.history],
            "shard": tr.shard_info(), "calls": dict(CALLS),
            "collectives": [[name for name, _ in r]
                            for r in tr.collective_log]}
    with open(os.path.join(out, f"fed_r{rank}.json"), "w") as fh:
        json.dump(meta, fh, default=float)


def main():
    import torch.distributed as dist
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import make_debug_mesh
    ctx = distributed.maybe_initialize()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    ranks, rank = ctx.num_processes, ctx.process_id
    assert ranks in (PAIR, QUAD), ctx
    if ranks == PAIR:
        _count_kernels()
        tp_layer(args.out, rank, dist.group.WORLD, PAIR, "tp_layer2")
        train_steps(args.out, rank, "tp_step", model_group=dist.group.WORLD)
        fed_rounds(args.out, rank)
    else:
        tp_layer(args.out, rank, dist.group.WORLD, QUAD, "tp_layer4")
        mesh = make_debug_mesh(2, 2)
        ep_layer(args.out, rank, mesh)
        train_steps(args.out, rank, "ep_step", moe_impl="ep", moe_mesh=mesh)
    print("TORCH_MOE_PARALLEL_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
