"""Decoder-only transformer stack (counterpart of repro/models/transformer.py):
its dense path (GQA attention and a dense MLP in every layer) and its
pure-SSM path (a Mamba-1 mixer is the whole layer, as in Falcon-Mamba).

The reference runs the periodic part of the stack with ``lax.scan`` over
stacked groups (``stack_plan``: a dense or pure-SSM arch is prefix 0,
period 1, groups = num_layers). The port keeps one parameter dict and one
cache or state per layer in a list, in the reference's execution order
(prefix layers, then group by group), and loops over them in Python.

  params = {"embed": (V, D), "final_norm": {...}, "lm_head": {...} unless
            tied, "layers": [{"norm1", "mixer", "norm2", "mlp"}, ...]}
            (an SSM layer is {"norm1", "mixer"})
  states = [per-layer attention cache (attention.init_cache) or SSM state
            {"conv", "h"} (ssm.init_ssm_state), ...]

Modes: prefill (full sequence, writes the caches and states) and decode
(S = 1 against them); without states, a full-sequence forward. MoE,
hybrid, MLA and VLM layers raise ``NotImplementedError``; training
(``loss_fn``) comes with a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_linear,
                                       init_mlp, init_norm, linear)

_TODO = "not ported to repro_torch yet (ROADMAP Queue 1 item 14)"


# ---------------- stack plan ----------------

def layer_specs(cfg) -> Tuple[Tuple[str, bool], ...]:
    kinds = cfg.layer_kinds()
    return tuple((kinds[i], cfg.layer_is_moe(i))
                 for i in range(cfg.num_layers))


def stack_plan(cfg) -> Tuple[int, int, int]:
    """-> (prefix_layers, period, groups) with prefix + period*groups == L."""
    specs = layer_specs(cfg)
    n = len(specs)
    for prefix in range(0, n):
        rest = specs[prefix:]
        if not rest:
            break
        for period in range(1, min(len(rest), 16) + 1):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period, len(rest) // period
    return n, 0, 0          # fully heterogeneous: all layers in prefix


def _check_ported(cfg):
    """Dense decoders and pure-SSM stacks pass; everything else raises
    (MLA in the attention module)."""
    if cfg.arch_type not in ("dense", "ssm") or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r}, modality="
            f"{cfg.modality!r} is {_TODO}; the port carries dense decoders "
            "and pure-SSM stacks")
    want = "attn" if cfg.arch_type == "dense" else "ssm"
    for kind, is_moe in layer_specs(cfg):
        if kind != want or is_moe:
            raise NotImplementedError(
                f"{cfg.name}: a {kind} layer{' with MoE' if is_moe else ''}"
                f" in a {cfg.arch_type} stack is {_TODO}")


# ---------------- single layer ----------------

def _init_layer(gen, cfg, dtype):
    dev = gen.device
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev)}
    if cfg.arch_type == "ssm":          # the mamba block IS the layer
        p["mixer"] = ssm_mod.init_mamba(gen, cfg, dtype)
        return p
    p["mixer"] = attn_mod.init_attention(gen, cfg, dtype)
    p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    p["mlp"] = init_mlp(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dtype,
                        cfg.mlp_bias)
    return p


def _layer_forward(cfg, p, x, positions, state, *, window, attn_impl,
                   ssm_impl):
    h = apply_norm(cfg.norm, p["norm1"], x)
    if cfg.arch_type == "ssm":
        mixed, new_state = ssm_mod.mamba_forward(cfg, p["mixer"], h,
                                                 state=state, impl=ssm_impl)
        return x + mixed, new_state
    mixed, new_state = attn_mod.attention_forward(
        cfg, p["mixer"], h, positions, window=window, cache=state,
        impl=attn_impl)
    x = x + mixed
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    return x + apply_mlp(cfg.mlp, p["mlp"], h2), new_state


# ---------------- full model ----------------

def init_lm(cfg, gen: torch.Generator, dtype=None):
    """Parameters drawn from ``gen`` (on its device) with the reference's
    distributions: embed N(0, 0.02^2), linear N(0, 1/fan_in), zero
    biases, unit norm scales."""
    _check_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=gen.device) * 0.02).to(dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        dtype)
    params["layers"] = [_init_layer(gen, cfg, dtype)
                        for _ in range(cfg.num_layers)]
    return params


def init_states(cfg, batch, capacity, dtype=None, device=None) -> List:
    """One empty cache of ``capacity`` slots per attention layer; one
    zero SSM state ({"conv": (B, cw - 1, d_in) in dtype, "h": (B, d_in,
    N) f32}) per SSM layer, whatever the capacity."""
    _check_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    if cfg.arch_type == "ssm":
        return [ssm_mod.init_ssm_state(cfg, batch, dtype, device)
                for _ in range(cfg.num_layers)]
    return [attn_mod.init_cache(cfg, batch, capacity, dtype, device)
            for _ in range(cfg.num_layers)]


def _embed_inputs(cfg, params, tokens, embeds):
    if embeds is not None:
        raise NotImplementedError(f"VLM patch embeddings are {_TODO}")
    return params["embed"][tokens]


def lm_forward(cfg, params, tokens, positions=None, *, embeds=None,
               states: Optional[List] = None, window: int = 0,
               attn_impl: str = "auto", ssm_impl: str = "auto",
               logits_slice_last: bool = False):
    """Returns (logits, new_states, aux_loss); aux_loss is 0 (no MoE).

    tokens (B, S) int. states from init_states: prefill fills them,
    decode (S = 1) steps them — the attention caches are written in place,
    the SSM states replaced, and all returned in a new list. ``attn_impl``
    goes to every attention call, ``ssm_impl`` ("auto" | "reference") to
    every SSM mixer."""
    _check_ported(cfg)
    x = _embed_inputs(cfg, params, tokens, embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    new_states = None if states is None else []
    for i, p in enumerate(params["layers"]):
        x, nst = _layer_forward(cfg, p, x, positions,
                                None if states is None else states[i],
                                window=window, attn_impl=attn_impl,
                                ssm_impl=ssm_impl)
        if states is not None:
            new_states.append(nst)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if logits_slice_last:
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = linear(params["lm_head"], x)
    return logits, new_states, torch.zeros((), dtype=torch.float32,
                                           device=x.device)
