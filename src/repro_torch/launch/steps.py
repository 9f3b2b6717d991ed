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
the reference's trees (``params_spec``: ``init_lm``'s key tree;
``states_spec``: the stacked caches of ``init_states``). The steps run
the port's decoders (transformer.py): the encoder-decoder branches raise
``NotImplementedError`` (ROADMAP Queue 1 item 14), as do ``moe_impl``,
``moe_groups`` and ``shard_fn`` at any value other than the default (MoE
is item 14, sharding item 13).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import META

WINDOW = 4096                 # sliding window for dense long-context decode
_ENCDEC = "encoder-decoder steps are not ported to repro_torch yet " \
          "(ROADMAP Queue 1 item 14)"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _refuse(cfg, moe_impl="gshard", moe_groups=1, shard_fn=None):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {_ENCDEC}")
    if moe_impl != "gshard" or moe_groups != 1:
        raise NotImplementedError(
            f"moe_impl={moe_impl!r}, moe_groups={moe_groups}: MoE is not "
            "ported to repro_torch yet (ROADMAP Queue 1 item 14)")
    if shard_fn is not None:
        raise NotImplementedError(
            "shard_fn: sharded steps are not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 13)")


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
    (params and states come from params_spec / states_spec)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {_ENCDEC}")
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
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
    """The reference's parameter tree (``init_lm``'s) in meta tensors."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {_ENCDEC}")
    return tf.init_lm(cfg, META)


def states_spec(cfg: ArchConfig, shape: InputShape):
    """The reference's ``init_states`` tree in meta tensors: {"prefix":
    (per-layer states), "stack": (per-position states with a leading
    groups axis)}; an attention cache's ``idx`` is an int32 scalar a
    layer (a (G,) vector in the stack)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {_ENCDEC}")
    tf._check_ported(cfg)
    cap, b, dtype = cache_capacity(cfg, shape), shape.global_batch, \
        _dtype(cfg)
    prefix, period, groups = tf.stack_plan(cfg)

    def one(i):
        if tf.layer_specs(cfg)[i][0] == "ssm":
            return ssm_mod.init_ssm_state(cfg, b, dtype, META)
        cache = attn_mod.init_cache(cfg, b, cap, dtype, META)
        return {**cache, "idx": _meta((), torch.int32)}

    stack = ()
    if groups:
        stack = tuple(
            {k: v.expand((groups,) + tuple(v.shape))
             for k, v in one(prefix + j).items()} for j in range(period))
    return {"prefix": tuple(one(i) for i in range(prefix)), "stack": stack}


# ---------------- steps ----------------

def make_train_step(cfg: ArchConfig, lr: float = 1e-3, remat: str = "full",
                    attn_impl: str = "auto", moe_groups: int = 1,
                    shard_fn=None, moe_impl: str = "gshard",
                    microbatches: int = 1):
    """(params, batch) -> (new_params, loss). Plain SGD, so a step is
    forward + backward + apply (the paper's local client step), under
    plain autograd: ``remat="full"`` checkpoints each layer
    (transformer._remat), "none" keeps every activation. The loss is
    ``transformer.loss_fn``'s training route.

    ``microbatches`` > 1 splits the batch into M sequential chunks and
    accumulates their f32 grads (live activations scale 1/M); the loss
    and grads are the chunks' means. The params tree is not modified: the
    step returns new leaves, each written as its grad is dropped."""
    _refuse(cfg, moe_impl, moe_groups, shard_fn)

    def grads_of(leaves, skeleton, batch):
        tree = bridge.tree_map(lambda i: leaves[i], skeleton)
        loss = tf.loss_fn(cfg, tree, batch, remat=remat,
                          attn_impl=attn_impl)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def train_step(params, batch):
        skeleton = bridge.layout_of(params).skeleton
        leaves = [p.detach().requires_grad_(True)
                  for p in bridge.tree_leaves(params)]
        if microbatches <= 1:
            loss, grads = grads_of(leaves, skeleton, batch)
        else:
            chunks = {k: torch.chunk(v, microbatches) for k, v in
                      batch.items()}
            if any(len(c) != microbatches for c in chunks.values()):
                raise ValueError(f"a batch of {len(batch['tokens'])} does "
                                 f"not split into {microbatches} chunks")
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for m in range(microbatches):
                mb = {k: c[m] for k, c in chunks.items()}
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


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      attn_impl: str = "auto", moe_groups: int = 1,
                      shard_fn=None, moe_impl: str = "gshard"):
    """(params, states, tokens, patch_embeds=None) -> (new_states,
    last_token_logits). ``states`` the port's per-layer list
    (transformer.init_states)."""
    _refuse(cfg, moe_impl, moe_groups, shard_fn)
    window = effective_window(cfg, shape)

    def prefill(params, states, tokens, patch_embeds=None):
        logits, new_states, _ = tf.lm_forward(
            cfg, params, tokens, embeds=patch_embeds, states=states,
            window=window, attn_impl=attn_impl, logits_slice_last=True)
        return new_states, logits

    return prefill


def make_decode_step(cfg: ArchConfig, shape: InputShape,
                     attn_impl: str = "auto", moe_groups: int = 1,
                     shard_fn=None, moe_impl: str = "gshard"):
    """(params, states, tokens (B, 1), positions (B, 1)) -> (states,
    logits)."""
    _refuse(cfg, moe_impl, moe_groups, shard_fn)
    window = effective_window(cfg, shape)

    def decode(params, states, tokens, positions):
        logits, new_states, _ = tf.lm_forward(
            cfg, params, tokens, positions=positions, states=states,
            window=window, attn_impl=attn_impl, logits_slice_last=True)
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
