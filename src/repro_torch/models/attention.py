"""Attention (counterpart of repro/models/attention.py, its GQA half):
grouped-query attention with an optional sliding window, and the
ring-buffer KV cache of the serving path:

  cache = {"k": (B, C, KV, HD), "v": (B, C, KV, HD),
           "pos": (B, C) int32 (-1 = empty), "idx": int next slot}

Full-sequence attention (``sdpa``) has three implementations:
  * "reference": plain einsum over the whole score tensor (the
    reference's ``_sdpa_reference``, plain PyTorch);
  * "blocked":   online-softmax attention over key blocks (the
    reference's ``_sdpa_blocked``, plain PyTorch);
  * "kernel":    the hand-written CUDA kernel, ``kernels/flash_attention``
    (its plain version on CPU tensors).
"auto" is "kernel" for every call on a CUDA tensor, prefill and decode,
so the card never runs a plain version on the path; on the CPU it keeps
the reference's rule (blocked only when Sk > BLOCKED_THRESHOLD and
Sq > 8, reference otherwise).

On a row with no visible key the three differ, as in the reference:
"reference" gives the uniform mean of v (bias + softmax), "blocked" the
sum of v over its block-padded key count, and the kernel 0 (as
``attention_ref``). The serving path never has such a row: every query
sees its own key.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       rope_frequencies)

NEG_INF = -1e30
BLOCKED_THRESHOLD = 2048  # the reference's rule on the CPU
IMPLS = ("auto", "reference", "blocked", "kernel")


# =====================  GQA  =====================

def init_gqa(gen: torch.Generator, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": init_linear(gen, d, cfg.num_heads * hd, dtype, cfg.attn_bias),
        "wk": init_linear(gen, d, cfg.num_kv_heads * hd, dtype,
                          cfg.attn_bias),
        "wv": init_linear(gen, d, cfg.num_kv_heads * hd, dtype,
                          cfg.attn_bias),
        "wo": init_linear(gen, cfg.num_heads * hd, d, dtype, cfg.attn_bias),
    }


def _mask_bias(q_pos, k_pos, window):
    """q_pos (..., Sq), k_pos (..., Sk) -> additive f32 bias (..., Sq, Sk)."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    ok &= k_pos[..., None, :] >= 0
    if window and window > 0:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _sdpa_reference(q, k, v, bias, soft_cap=0.0):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D), bias (B,Sq,Sk) -> (B,Sq,H,D).
    Products of the stored dtype summed in f32 (the reference's
    preferred_element_type); p is cast to v's dtype before p @ v."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qr = q.reshape(b, sq, kv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) \
        / math.sqrt(d)
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    s = s + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _sdpa_blocked(q, k, v, q_pos, k_pos, window, soft_cap=0.0):
    """Online-softmax attention over key blocks, in f32: O(Sq * block)
    memory instead of O(Sq * Sk)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    block = min(8192, max(512, sk // 64))   # <= ~64 blocks
    g = h // kv
    pad = (-sk) % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    nblk = (sk + pad) // block
    qf = q.reshape(b, sq, kv, g, d).float() / math.sqrt(d)
    m = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, d), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block, (i + 1) * block)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k[:, blk].float())
        if soft_cap:
            s = soft_cap * torch.tanh(s / soft_cap)
        bias = _mask_bias(q_pos, k_pos[:, blk], window)   # (b, sq, block)
        s = s + bias[:, None, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v[:, blk].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def sdpa(q, k, v, q_pos, k_pos, window=0, soft_cap=0.0, impl="auto"):
    """Full-sequence attention, q (B,Sq,H,D), k/v (B,Sk,KV,D), positions
    (B,Sq)/(B,Sk) -> (B,Sq,H,D); ``impl`` in IMPLS (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"sdpa: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        if q.device.type == "cuda":
            impl = "kernel"
        else:
            impl = ("blocked" if (k.shape[1] > BLOCKED_THRESHOLD
                                  and q.shape[1] > 8) else "reference")
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                      soft_cap=soft_cap)
    if impl == "blocked":
        return _sdpa_blocked(q, k, v, q_pos, k_pos, window, soft_cap)
    return _sdpa_reference(q, k, v, _mask_bias(q_pos, k_pos, window),
                           soft_cap)


def init_kv_cache(cfg, batch, capacity, dtype, device=None):
    hd = cfg.resolved_head_dim
    shape = (batch, capacity, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device),
            "idx": 0}


def _cache_write(cache, k, v, positions):
    """Write S new tokens at slots (idx + arange(S)) % C, IN PLACE (the
    reference returns new arrays; the port saves the copies) -> the
    cache dict with idx + S."""
    cap = cache["k"].shape[1]
    s = k.shape[1]
    if s > cap:
        raise ValueError(f"cache write of {s} tokens into a cache of "
                         f"capacity {cap}: slots would repeat")
    start = cache["idx"] % cap
    if start + s <= cap:
        slots = slice(start, start + s)
    else:                   # the ring wraps
        slots = (start + torch.arange(s, device=k.device)) % cap
    cache["k"][:, slots] = k
    cache["v"][:, slots] = v
    cache["pos"][:, slots] = positions.to(torch.int32)
    return {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
            "idx": cache["idx"] + s}


def gqa_forward(cfg, p, x, positions, *, window=0, cache=None, impl="auto"):
    """x (B, S, D), positions (B, S) int absolute positions.

    cache None  -> full-sequence self attention (prefill without a cache);
    cache given -> write the S tokens into it (prefill fills, decode S = 1)
                   and attend to the whole cache.
    Returns (out, new_cache)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.use_rope:
        cos, sin = rope_frequencies(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        out = sdpa(q, k, v, positions, positions, window=window,
                   soft_cap=cfg.logit_soft_cap, impl=impl)
        new_cache = None
    else:
        new_cache = _cache_write(cache, k, v, positions)
        out = sdpa(q, new_cache["k"], new_cache["v"], positions,
                   new_cache["pos"], window=window,
                   soft_cap=cfg.logit_soft_cap, impl=impl)
    return linear(p["wo"], out.reshape(b, s, cfg.num_heads * hd)), new_cache


# =====================  unified entry  =====================

def _gqa_only(cfg):
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported to repro_torch yet "
            "(MLA is ROADMAP Queue 1 item 14); the port carries GQA")


def init_attention(gen, cfg, dtype):
    _gqa_only(cfg)
    return init_gqa(gen, cfg, dtype)


def attention_forward(cfg, p, x, positions, *, window=0, cache=None,
                      impl="auto"):
    _gqa_only(cfg)
    return gqa_forward(cfg, p, x, positions, window=window, cache=cache,
                       impl=impl)


def init_cache(cfg, batch, capacity, dtype, device=None):
    _gqa_only(cfg)
    return init_kv_cache(cfg, batch, capacity, dtype, device)
