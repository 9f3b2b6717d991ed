"""Step functions and input specs for every (arch x shape) (counterpart of
repro/launch/steps.py).

Shapes map to step kinds (configs/shapes.py):
  train_4k    -> train_step    forward + backward + SGD apply on the batch
  prefill_32k -> prefill_step  full-sequence forward writing caches/states
  decode_32k  -> decode_step   ONE token against a seq_len cache
  long_500k   -> decode_step   SSM stacks decode natively; dense archs use
                               the sliding-window variant (a ring cache of
                               WINDOW tokens)

The reference returns ``jax.ShapeDtypeStruct`` stand-ins; the port
returns tensors on the meta device, of the same shapes and dtypes, in
the reference's trees (``params_spec``: ``init_lm``'s or
``init_encdec``'s key tree; ``states_spec``: the stacked caches of
``init_states`` or ``init_decoder_states``). The steps run the port's
decoders (transformer.py) and the encoder-decoder (encdec.py). MoE
layers route their tokens in ``moe_groups`` groups and call
``shard_fn(tensor, role)``, the reference's placement hook, at its three
points (models/moe.py).

``make_train_step(cfg, model_group=...)`` is the reference's train step
jit'd with ``param_specs`` in-shardings, written out by hand: Megatron
tensor parallelism over the model group for the dense decoder family and
the MoE decoders whose attention is GQA (sharding/tensor_parallel.py,
models/moe.py's tensor-parallel experts), each rank stepping its shard
of the flat parameter vector. ``make_train_step(cfg, moe_impl="ep",
moe_mesh=make_debug_mesh(S, M))`` is the reference's expert-parallel
step (models/moe_ep.py) on every rank of a (data, model) mesh: the
expert stacks split on E over ``data`` and on their ffn dim over
``model``, the rest Megatron over ``model``, each rank on its rows of
the batch. The prefill and decode steps serve on one process: "ep"
raises there (serving over ranks is ROADMAP Queue 1 item 13i).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import moe_ep as moe_ep_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import META
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.layout import ShardLayout, TPView
from repro_torch.sharding.rules import mesh_axes

WINDOW = 4096                 # sliding window for dense long-context decode


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def effective_window(cfg: ArchConfig, shape: InputShape) -> int:
    if shape.long_context and cfg.arch_type not in ("ssm", "hybrid"):
        return WINDOW
    return cfg.sliding_window


def cache_capacity(cfg: ArchConfig, shape: InputShape) -> int:
    w = effective_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


# ---------------- input specs ----------------

def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the *data* arguments of the step
    (params and states come from params_spec / states_spec). An
    encoder-decoder's train and prefill steps take the stubbed frames
    (B, T_enc, D) and min(seq_len, max_seq_len) decoder tokens."""
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if cfg.is_encoder_decoder and shape.kind in ("train", "prefill"):
        dec_len = min(s, cfg.max_seq_len)
        specs = {"frames": _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                 _dtype(cfg)),
                 "tokens": _meta((b, dec_len), tok)}
        if shape.kind == "prefill":
            return specs
        return {"batch": {**specs, "labels": _meta((b, dec_len), tok)}}
    if shape.kind in ("train", "prefill"):
        if cfg.modality == "vision":
            p = cfg.num_patches
            specs = {"tokens": _meta((b, s - p), tok),
                     "patch_embeds": _meta((b, p, cfg.d_model),
                                           _dtype(cfg))}
            if shape.kind == "train":
                specs["labels"] = _meta((b, s - p), tok)
        else:
            specs = {"tokens": _meta((b, s), tok)}
            if shape.kind == "train":
                specs["labels"] = _meta((b, s), tok)
        return {"batch": specs} if shape.kind == "train" else specs
    # decode: ONE new token; the cache already holds shape.seq_len history
    return {"tokens": _meta((b, 1), tok), "positions": _meta((b, 1), tok)}


def params_spec(cfg: ArchConfig):
    """The reference's parameter tree (``init_lm``'s or
    ``init_encdec``'s) in meta tensors."""
    if cfg.is_encoder_decoder:
        return encdec_mod.init_encdec(cfg, META)
    return tf.init_lm(cfg, META)


def _meta_cache(cache, lead=()):
    """A cache of meta tensors with ``idx`` an int32 scalar, every leaf
    with the leading dims ``lead``."""
    cache = {**cache, "idx": _meta((), torch.int32)}
    return {k: v.expand(lead + tuple(v.shape)) for k, v in cache.items()}


def states_spec(cfg: ArchConfig, shape: InputShape):
    """The reference's ``init_states`` tree in meta tensors: {"prefix":
    (per-layer states), "stack": (per-position states with a leading
    groups axis)}; an attention cache's ``idx`` is an int32 scalar a
    layer (a (G,) vector in the stack). An encoder-decoder's: {"decoder":
    its self-attention caches stacked over layers, "enc_out": (B, T_enc,
    D)}."""
    cap, b, dtype = cache_capacity(cfg, shape), shape.global_batch, \
        _dtype(cfg)
    if cfg.is_encoder_decoder:
        cache = attn_mod.init_kv_cache(cfg, b, cap, dtype, META)
        return {"decoder": _meta_cache(cache, (cfg.num_layers,)),
                "enc_out": _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                 dtype)}
    tf._check_config(cfg)
    prefix, period, groups = tf.stack_plan(cfg)

    def one(i, lead=()):
        if tf.layer_specs(cfg)[i][0] == "ssm":
            st = ssm_mod.init_ssm_state(cfg, b, dtype, META)
            return {k: v.expand(lead + tuple(v.shape))
                    for k, v in st.items()}
        return _meta_cache(attn_mod.init_cache(cfg, b, cap, dtype, META),
                           lead)

    stack = tuple(one(prefix + j, (groups,)) for j in range(period)) \
        if groups else ()
    return {"prefix": tuple(one(i) for i in range(prefix)), "stack": stack}


# ---------------- steps ----------------

def make_train_step(cfg: ArchConfig, lr: float = 1e-3, remat: str = "full",
                    attn_impl: str = "auto", moe_groups: int = 1,
                    shard_fn=None, moe_impl: str = "gshard", moe_mesh=None,
                    microbatches: int = 1, model_group=None):
    """(params, batch) -> (new_params, loss). Plain SGD, so a step is
    forward + backward + apply (the paper's local client step), under
    plain autograd: ``remat="full"`` checkpoints each layer
    (transformer._remat), "none" keeps every activation. The loss is
    ``transformer.loss_fn``'s training route.

    ``microbatches`` > 1 splits the batch into M sequential chunks and
    accumulates their f32 grads (live activations scale 1/M); the loss
    and grads are the chunks' means. The params tree is not modified: the
    step returns new leaves, each written as its grad is dropped. An
    encoder-decoder's loss is ``encdec.encdec_loss_fn`` (no remat, as in
    the reference). ``shard_fn`` goes to the MoE layers
    (moe.moe_forward).

    ``model_group`` (a process group of M ranks, each on its device)
    makes it the tensor-parallel step of this rank: (shard, batch) ->
    (shard, loss), the shard updated in place (each block's gradient
    applied as it is dropped); ``shard`` is this rank's (N_m,) f32 shard
    of the flat parameter vector of ``params_spec(cfg)`` under
    sharding/rules.cohort_param_specs on a (1 x M) mesh —
    ``train_step.shards`` (a sharding/layout.ShardLayout) scatters and
    gathers it. Every rank steps the same batch; the loss is
    the same on each. The families of
    ``transformer.tensor_parallel_refusal``: GQA decoders with dense or
    MoE MLPs; MLA, Mamba and encoder-decoder stacks raise, each citing
    its ROADMAP item.

    ``moe_impl="ep"`` with ``moe_mesh`` (launch/mesh.make_debug_mesh(S,
    M) over the job's S·M ranks) makes it this rank's expert-parallel
    step (``_make_ep_train_step``): (shard, batch) -> (shard, loss), the
    batch whole (every rank takes its rows), the shard the rank's of
    ``train_step.shards`` (sharding/layout.ShardLayout.for_experts)."""
    tf._check_moe_impl(moe_impl)
    if moe_impl == "ep":
        return _make_ep_train_step(cfg, lr, remat, attn_impl, microbatches,
                                   moe_mesh)
    if model_group is not None:
        return _make_tp_train_step(cfg, lr, remat, attn_impl, microbatches,
                                   model_group, moe_groups)

    def loss_of(tree, batch):
        if cfg.is_encoder_decoder:
            return encdec_mod.encdec_loss_fn(cfg, tree, batch,
                                             attn_impl=attn_impl)
        return tf.loss_fn(cfg, tree, batch, remat=remat,
                          attn_impl=attn_impl, moe_groups=moe_groups,
                          shard_fn=shard_fn)

    def grads_of(leaves, skeleton, batch):
        loss = loss_of(bridge.tree_map(lambda i: leaves[i], skeleton), batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def train_step(params, batch):
        skeleton = bridge.layout_of(params).skeleton
        leaves = [p.detach().requires_grad_(True)
                  for p in bridge.tree_leaves(params)]
        if microbatches <= 1:
            loss, grads = grads_of(leaves, skeleton, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for mb in _microbatches(batch, microbatches):
                l_m, g_m = grads_of(leaves, skeleton, mb)
                loss = loss + l_m
                for acc, g in zip(grads, g_m):
                    acc.add_(g.float())
                del g_m
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
        new = []
        for i, p in enumerate(leaves):
            with torch.no_grad():
                new.append((p - lr * grads[i].to(p.dtype)).to(p.dtype))
            grads[i] = None
        return bridge.tree_map(lambda i: new[i], skeleton), loss

    return train_step


def _microbatches(batch, n: int):
    chunks = {k: torch.chunk(v, n) for k, v in batch.items()}
    if any(len(c) != n for c in chunks.values()):
        raise ValueError(f"a batch of {len(batch['tokens'])} does not "
                         f"split into {n} chunks")
    return [{k: c[m] for k, c in chunks.items()} for m in range(n)]


def _make_tp_train_step(cfg, lr, remat, attn_impl, microbatches, group,
                        moe_groups=1):
    """make_train_step's tensor-parallel form (its docstring)."""
    tf.check_tensor_parallel(cfg)
    model = dist.get_world_size(group)
    shards = ShardLayout.from_sizes(bridge.layout_of(params_spec(cfg)),
                                    {"clients": 1, "model": model})
    tp = tpm.TPContext.of(group)
    view = TPView(shards, tp.rank, cfg.resolved_head_dim, tp)

    def loss_of(tree, batch):
        return tf.loss_fn(cfg, tree, batch, remat=remat, attn_impl=attn_impl,
                          moe_groups=moe_groups, tp=tp)

    train_step = _shard_step(view, loss_of, lr, microbatches)
    train_step.shards, train_step.view, train_step.tp = shards, view, tp
    return train_step


def _shard_step(view, loss_of, lr, microbatches, rows=None, grad_sync=None):
    """(shard, batch) -> (shard, loss): SGD on a rank's shard, each held
    leaf a block of its own (its gradient applied and dropped, never
    concatenated into an (N_m,) gradient). ``rows(batch)`` is the rank's
    part of a (micro)batch; ``grad_sync(grads)`` completes the gradients
    before the step (in place)."""
    rows = rows or (lambda b: b)

    def grads_of(blocks, batch):
        loss = loss_of(view.tree(blocks), rows(batch))
        return loss.detach(), list(torch.autograd.grad(loss, blocks))

    def train_step(shard, batch):
        if shard.shape != (view.size,):
            raise ValueError(f"rank {view.m}'s shard is ({view.size},), "
                             f"got {tuple(shard.shape)}")
        blocks = [b.detach().requires_grad_(True)
                  for b in view.split(shard)]
        if microbatches <= 1:
            loss, grads = grads_of(blocks, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=shard.device)
            grads = [torch.zeros_like(b) for b in blocks]
            for mb in _microbatches(batch, microbatches):
                l_m, g_m = grads_of(blocks, mb)
                loss = loss + l_m
                for acc, g in zip(grads, g_m):
                    acc.add_(g)
                del g_m
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
        if grad_sync is not None:
            grad_sync(grads)
        with torch.no_grad():
            for i, b in enumerate(blocks):
                b.sub_(grads[i].mul_(lr))       # p - lr·g, in place
                grads[i] = None
        return shard, loss

    return train_step


def _make_ep_train_step(cfg, lr, remat, attn_impl, microbatches, mesh):
    """make_train_step's expert-parallel form on this rank of ``mesh``.

    Rank (d, m) holds its shard of ``ShardLayout.for_experts``: its E/S
    experts' F/M columns, the other leaves Megatron over the model axis
    (and whole over ``data``). It runs the forward on rows [d·B/S,
    (d+1)·B/S) of the batch (of each microbatch), the MoE layers through
    moe_ep.moe_forward_ep. ``transformer.loss_fn`` makes its loss the
    whole batch's and its gradient this rank's share, so:

      * an expert block's gradient is complete as it comes: the reverse
        all-to-all's backward brings every rank's tokens' cotangents to
        the experts that served them, each already its share of the
        whole batch's mean (no 1/S, which the step would owe a loss
        averaged over the ranks' local means);
      * every other leaf's gradient is summed over the data group
        ("data_grad_sum", one all-reduce a leaf), so the data rows'
        copies step alike.

    The loss is the same on every rank."""
    if mesh is None:
        raise ValueError("moe_impl='ep' needs moe_mesh "
                         "(launch/mesh.make_debug_mesh)")
    sizes = mesh_axes(mesh)
    data, model = sizes["data"], sizes["model"]
    d, m = (int(c) for c in mesh.get_coordinate())
    ep, tp = moe_ep_mod.contexts(mesh, "data")
    if tp is not None:
        tf.check_tensor_parallel(cfg)
    shards = ShardLayout.for_experts(bridge.layout_of(params_spec(cfg)),
                                     data, model)
    view = TPView(shards, m, cfg.resolved_head_dim, tp, rank=d * model + m)
    held = [i for i, _ in shards.held(d * model + m)]
    common = [j for j, i in enumerate(held)
              if "data" not in shards.specs[i]]

    def rows(batch):
        b = batch["tokens"].shape[0]
        if b % data:
            raise ValueError(f"a batch of {b} rows over {data} data ranks")
        per = b // data
        return {k: v[d * per:(d + 1) * per] for k, v in batch.items()}

    def grad_sync(grads):
        if ep is None:
            return
        for j in common:
            g = grads[j]
            ep._timed("data_grad_sum", g, lambda g=g: dist.all_reduce(
                g, group=ep.group))

    def loss_of(tree, batch):
        return tf.loss_fn(cfg, tree, batch, remat=remat, attn_impl=attn_impl,
                          moe_impl="ep", moe_mesh=mesh, ep=ep, tp=tp)

    train_step = _shard_step(view, loss_of, lr, microbatches, rows,
                             grad_sync)
    train_step.shards, train_step.view = shards, view
    train_step.tp, train_step.ep, train_step.coords = tp, ep, (d, m)
    return train_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      attn_impl: str = "auto", moe_groups: int = 1,
                      shard_fn=None, moe_impl: str = "gshard"):
    """(params, states, tokens, patch_embeds=None) -> (new_states,
    last_token_logits). ``states`` the port's per-layer list
    (transformer.init_states). An encoder-decoder's is (params, states,
    frames, tokens) with states {"decoder": the per-layer caches
    (encdec.init_decoder_states), ...} -> ({"decoder", "enc_out"},
    last_token_logits)."""
    tf._check_moe_impl(moe_impl, serving=True)
    window = effective_window(cfg, shape)

    if cfg.is_encoder_decoder:
        def prefill_encdec(params, states, frames, tokens):
            enc_out = encdec_mod.encode(cfg, params, frames, attn_impl)
            logits, dec_states = encdec_mod.decode(
                cfg, params, tokens, enc_out, states=states["decoder"],
                window=window, attn_impl=attn_impl)
            return ({"decoder": dec_states, "enc_out": enc_out},
                    logits[:, -1:, :])
        return prefill_encdec

    def prefill(params, states, tokens, patch_embeds=None):
        logits, new_states, _ = tf.lm_forward(
            cfg, params, tokens, embeds=patch_embeds, states=states,
            window=window, attn_impl=attn_impl, logits_slice_last=True,
            moe_groups=moe_groups, shard_fn=shard_fn)
        return new_states, logits

    return prefill


def make_decode_step(cfg: ArchConfig, shape: InputShape,
                     attn_impl: str = "auto", moe_groups: int = 1,
                     shard_fn=None, moe_impl: str = "gshard"):
    """(params, states, tokens (B, 1), positions (B, 1)) -> (states,
    logits). An encoder-decoder's states are {"decoder", "enc_out"}: the
    step attends across to "enc_out" and carries it on."""
    tf._check_moe_impl(moe_impl, serving=True)
    window = effective_window(cfg, shape)

    if cfg.is_encoder_decoder:
        def decode_encdec(params, states, tokens, positions):
            logits, dec_states = encdec_mod.decode(
                cfg, params, tokens, states["enc_out"], positions=positions,
                states=states["decoder"], window=window, attn_impl=attn_impl)
            return ({"decoder": dec_states, "enc_out": states["enc_out"]},
                    logits)
        return decode_encdec

    def decode(params, states, tokens, positions):
        logits, new_states, _ = tf.lm_forward(
            cfg, params, tokens, positions=positions, states=states,
            window=window, attn_impl=attn_impl, logits_slice_last=True,
            moe_groups=moe_groups, shard_fn=shard_fn)
        return new_states, logits

    return decode


def make_step(cfg: ArchConfig, shape: InputShape, **kw):
    """Uniform entry: returns (step_fn, arg_specs_dict, has_states)."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        return make_train_step(cfg, **kw), specs, False
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw), specs, True
    return make_decode_step(cfg, shape, **kw), specs, True
