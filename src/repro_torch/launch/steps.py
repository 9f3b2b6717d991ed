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
layers route their tokens in ``moe_groups`` groups on one device and
call ``shard_fn(tensor, role)``, the reference's placement hook, at its
three points (models/moe.py); ``moe_impl="ep"`` (the expert-parallel
MoE, ROADMAP Queue 1 item 13c) raises.

``make_train_step(cfg, model_group=...)`` is the reference's train step
jit'd with ``param_specs`` in-shardings, written out by hand: Megatron
tensor parallelism over the model group for the dense decoder family
(sharding/tensor_parallel.py), each rank stepping its shard of the
flat parameter vector.
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import META
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.layout import ShardLayout, TPView

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
                    shard_fn=None, moe_impl: str = "gshard",
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
    the same on each. The dense decoder family only: MoE, MLA, Mamba
    and encoder-decoder stacks raise, each citing its ROADMAP item."""
    tf._check_moe_impl(moe_impl)
    if model_group is not None:
        return _make_tp_train_step(cfg, lr, remat, attn_impl, microbatches,
                                   model_group)

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


def _make_tp_train_step(cfg, lr, remat, attn_impl, microbatches, group):
    """make_train_step's tensor-parallel form (its docstring)."""
    tf.check_tensor_parallel(cfg)
    model = dist.get_world_size(group)
    shards = ShardLayout.from_sizes(bridge.layout_of(params_spec(cfg)),
                                    {"clients": 1, "model": model})
    tp = tpm.TPContext.of(group)
    view = TPView(shards, tp.rank, cfg.resolved_head_dim, tp)

    def grads_of(blocks, batch):
        loss = tf.loss_fn(cfg, view.tree(blocks), batch, remat=remat,
                          attn_impl=attn_impl, tp=tp)
        return loss.detach(), list(torch.autograd.grad(loss, blocks))

    def train_step(shard, batch):
        if shard.shape != (view.size,):
            raise ValueError(f"rank {tp.rank}'s shard is ({view.size},), "
                             f"got {tuple(shard.shape)}")
        # each block a leaf of its own: its gradient is applied and
        # dropped, never concatenated into an (N_m,) gradient
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
        with torch.no_grad():
            for i, b in enumerate(blocks):
                b.sub_(grads[i].mul_(lr))       # p - lr·g, in place
                grads[i] = None
        return shard, loss

    train_step.shards, train_step.view, train_step.tp = shards, view, tp
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
    tf._check_moe_impl(moe_impl)
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
    tf._check_moe_impl(moe_impl)
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
