"""Attention (counterpart of repro/models/attention.py): grouped-query
attention with an optional sliding window, DeepSeek-V2's multi-head
latent attention (MLA), and the ring-buffer caches of the serving path:

  GQA cache = {"k": (B, C, KV, HD), "v": (B, C, KV, HD),
               "pos": (B, C) int32 (-1 = empty), "idx": int next slot}
  MLA cache = {"c_kv": (B, C, kv_lora_rank), "k_rope": (B, C, rope dim),
               "pos", "idx"} — the compressed latent and the shared RoPE
               key a token (576 numbers for DeepSeek-V2)

Full-sequence attention (``sdpa``) has these implementations:
  * "reference": plain einsum over the whole score tensor (the
    reference's ``_sdpa_reference``, plain PyTorch);
  * "blocked":   online-softmax attention over key blocks (the
    reference's ``_sdpa_blocked``, plain PyTorch);
  * "plain":     the reference's own rule between those two, on any
    device (blocked only when Sk > BLOCKED_THRESHOLD and Sq > 8,
    reference otherwise);
  * "kernel":    the hand-written CUDA kernel, ``kernels/flash_attention``
    (its plain version on CPU tensors).
"auto" is "kernel" for every call on a CUDA tensor, prefill and decode,
so the card never runs a plain version on the serving path, and on a
meta tensor (the dry-run's serving step is the card's: the kernel's
wrapper records its cost); on the CPU it is "plain".

The training route is "plain", on every device. Neither the flash
kernel nor the reference's Pallas kernel has a backward, and the
reference's training never reaches Pallas (its "auto" picks only
reference or blocked). So ``transformer.loss_fn`` maps "auto" to "plain"
(and the Mamba mixer to its plain scan), and the kernel's wrapper raises
a ValueError on an input that requires grad or is wrapped by a
``torch.func`` transform: a route chosen by the mode, as in the
reference, never a fallback. Serving keeps the kernel.

On a row with no visible key the three differ, as in the reference:
"reference" gives the uniform mean of v (bias + softmax), "blocked" the
sum of v over its block-padded key count, and the kernel 0 (as
``attention_ref``). The serving path never has such a row: every query
sees its own key.

MLA's prefill and training materialise per-head K and V from the latent
and pad V up to the query-key head dim, so ``sdpa`` (and on the card the
kernel) sees one D. Its decode (S = 1 against a cache) is the
reference's absorbed form: k_up folded into the query and v_up into the
output, f32 einsums over the latent cache in plain PyTorch — the
reference computes it outside Pallas too, so it launches no kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       rng_device, row_parallel,
                                       rope_frequencies, split_rng)
from repro_torch.sharding import tensor_parallel as tpm

NEG_INF = -1e30
BLOCKED_THRESHOLD = 2048  # the reference's rule on the CPU
IMPLS = ("auto", "plain", "reference", "blocked", "kernel")


# =====================  GQA  =====================

def init_gqa(rng, cfg, dtype):
    """``rng``: a torch.Generator, a jax_prng key or "meta" (layers.py)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ks = split_rng(rng, 4)
    return {
        "wq": init_linear(ks[0], d, cfg.num_heads * hd, dtype,
                          cfg.attn_bias),
        "wk": init_linear(ks[1], d, cfg.num_kv_heads * hd, dtype,
                          cfg.attn_bias),
        "wv": init_linear(ks[2], d, cfg.num_kv_heads * hd, dtype,
                          cfg.attn_bias),
        "wo": init_linear(ks[3], cfg.num_heads * hd, d, dtype,
                          cfg.attn_bias),
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


def sdpa(q, k, v, q_pos, k_pos, window=0, soft_cap=0.0, impl="auto",
         all_visible=False):
    """Full-sequence attention, q (B,Sq,H,D), k/v (B,Sk,KV,D), positions
    (B,Sq)/(B,Sk) -> (B,Sq,H,D); ``impl`` in IMPLS (module docstring).
    ``all_visible``: the positions make every key visible (the kernel's
    meta count reads it: fa_ops.flash_attention)."""
    if impl not in IMPLS:
        raise ValueError(f"sdpa: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "kernel" if q.device.type in ("cuda", "meta") else "plain"
    if impl == "plain":
        impl = ("blocked" if (k.shape[1] > BLOCKED_THRESHOLD
                              and q.shape[1] > 8) else "reference")
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                      soft_cap=soft_cap,
                                      all_visible=all_visible)
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


def _ring_write(cache, new, positions):
    """Write S new tokens (``new``: cache key -> (B, S, ...)) and their
    positions at slots (idx + arange(S)) % C, IN PLACE (the reference
    returns new arrays; the port saves the copies) -> the cache dict with
    idx + S."""
    cap = cache["pos"].shape[1]
    s = positions.shape[1]
    if s > cap:
        raise ValueError(f"cache write of {s} tokens into a cache of "
                         f"capacity {cap}: slots would repeat")
    start = cache["idx"] % cap
    if start + s <= cap:
        slots = slice(start, start + s)
    else:                   # the ring wraps
        slots = (start + torch.arange(s, device=positions.device)) % cap
    for key, x in new.items():
        cache[key][:, slots] = x
    cache["pos"][:, slots] = positions.to(torch.int32)
    return {**{key: cache[key] for key in new}, "pos": cache["pos"],
            "idx": cache["idx"] + s}


def _cache_write(cache, k, v, positions):
    """A GQA cache's ``_ring_write`` of k and v."""
    return _ring_write(cache, {"k": k, "v": v}, positions)


def _tp_kv(cfg, p, x, tp, heads):
    """K and V (B, S, ·, HD) of ``x`` (the keys' source: the layer's
    input, or the encoder's output for cross-attention) for this rank's
    ``heads`` query heads under tensor parallelism: the KV heads [lo, hi)
    they read (sharding/tensor_parallel.kv_span), from ``wk``/``wv``
    holding just those heads — split over the model group when M divides
    the KV heads, or cut so for serving (sharding/layout.TPView.
    serving_params) — or from their columns of the whole leaves
    (sharding/layout.PARTIAL). When the rank's heads do not cover the
    heads' groups evenly, one KV head a query head (index-selected)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    lo, hi, sel = tpm.kv_span(cfg.num_heads, cfg.num_kv_heads, tp.rank,
                              heads)
    wk, wv = p["wk"], p["wv"]
    if wk["w"].shape[-1] != (hi - lo) * hd:         # the whole leaves
        cols = slice(lo * hd, hi * hd)
        wk, wv = ({k: t[..., cols] for k, t in lin.items()}
                  for lin in (wk, wv))
    k = linear(wk, x).reshape(b, s, hi - lo, hd)
    v = linear(wv, x).reshape(b, s, hi - lo, hd)
    if sel is None:
        return k, v
    idx = torch.tensor(sel, device=x.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def tp_of(cfg, tp):
    """The context ``cfg``'s GQA attention runs under: ``tp``, or None
    where its weights are whole on every rank of the group (the model
    axis does not divide the query heads: tensor_parallel.
    attention_whole, which sharding/layout's classes follow) — every rank
    then computes every head as one process does, and nothing is summed
    after ``wo``."""
    if tp is not None and tpm.attention_whole(cfg, tp.size):
        return None
    return tp


def gqa_forward(cfg, p, x, positions, *, window=0, cache=None, impl="auto",
                tp=None):
    """x (B, S, D), positions (B, S) int absolute positions.

    cache None  -> full-sequence self attention (prefill without a cache);
    cache given -> write the S tokens into it (prefill fills, decode S = 1)
                   and attend to the whole cache.
    ``tp`` (sharding/tensor_parallel.TPContext) runs Megatron's attention
    on this rank's query heads: ``wq`` (and ``wk``/``wv`` when split)
    column-parallel after a copy-to-region of x, ``wo`` row-parallel, its
    bias added after the sum (_tp_kv). Serving with ``tp``, the cache
    holds the KV heads _tp_kv gives the rank (KV / M when M divides the
    KV heads; else the heads its query block spans, or one a query head
    where the block splits a group unevenly); ``pos`` and ``idx`` are
    the same on every rank. Weights whole on every rank (``tp_of``) run
    as one process's, the cache every KV head. Returns (out,
    new_cache)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = tp_of(cfg, tp)
    x = tpm.copy_to_region(x, tp)
    q = linear(p["wq"], x)
    heads = q.shape[-1] // hd
    q = q.reshape(b, s, heads, hd)
    if tp is None:
        k = linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
        v = linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    else:
        k, v = _tp_kv(cfg, p, x, tp, heads)
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
    return row_parallel(p["wo"], out.reshape(b, s, heads * hd),
                        tp), new_cache


# =====================  MLA (DeepSeek-V2)  =====================

def init_mla(rng, cfg, dtype):
    """``rng``: a torch.Generator, a jax_prng key or "meta" (layers.py)."""
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dev = rng_device(rng)
    ks = split_rng(rng, 7)
    return {
        "q_down": init_linear(ks[0], d, cfg.q_lora_rank, dtype),
        "q_norm": {"scale": torch.ones(cfg.q_lora_rank, dtype=dtype,
                                       device=dev)},
        "q_up": init_linear(ks[1], cfg.q_lora_rank, h * qk, dtype),
        "kv_down": init_linear(ks[2], d,
                               cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                               dtype),
        "kv_norm": {"scale": torch.ones(cfg.kv_lora_rank, dtype=dtype,
                                        device=dev)},
        "k_up": init_linear(ks[3], cfg.kv_lora_rank,
                            h * cfg.qk_nope_head_dim, dtype),
        "v_up": init_linear(ks[4], cfg.kv_lora_rank, h * cfg.v_head_dim,
                            dtype),
        "wo": init_linear(ks[5], h * cfg.v_head_dim, d, dtype),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def init_mla_cache(cfg, batch, capacity, dtype, device=None):
    return {"c_kv": torch.zeros((batch, capacity, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, capacity, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device),
            "idx": 0}


def _mla_q(cfg, p, x, positions, tp=None):
    """The queries' nope and RoPE parts (B, S, heads, ·): all heads, or
    with ``tp`` this rank's (``q_up`` column-parallel on the latent,
    which enters the region after its norm)."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    c_q = _rms(linear(p["q_down"], x), p["q_norm"]["scale"])
    q = linear(p["q_up"], tpm.copy_to_region(c_q, tp))
    q = q.reshape(b, s, -1, nope + rope)
    cos, sin = rope_frequencies(rope, cfg.rope_theta, positions)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin)


def _mla_kv_compress(cfg, p, x, positions):
    kv = linear(p["kv_down"], x)
    c_kv = _rms(kv[..., :cfg.kv_lora_rank], p["kv_norm"]["scale"])
    cos, sin = rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta,
                                positions)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank:][:, :, None, :], cos,
                        sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(cfg, p, x, positions, *, window=0, cache=None, impl="auto",
                tp=None):
    """MLA attention, x (B, S, D) -> (out, new_cache). The cache holds the
    COMPRESSED kv (c_kv + the shared k_rope). Decode (S = 1 with a cache)
    is the absorbed form; otherwise per-head K and V are materialised
    from the latent (the whole cache when there is one) and V is padded
    to the query-key head dim for ``sdpa`` (module docstring).

    ``tp`` (sharding/tensor_parallel.TPContext) runs Megatron's MLA on
    this rank's heads. Every rank computes ``q_down``, ``kv_down``, the
    two latent norms and k_rope's RoPE alike from x, which enters no
    region (x reaches ``wo`` only through them: a copy-to-region of x as
    well would sum its gradient once more). The region starts after
    them: c_q, c_kv and k_rope each pass a copy-to-region,
    ``q_up``/``k_up``/``v_up`` are column-parallel on the rank's heads
    and ``wo`` row-parallel. Serving with ``tp``, the latent cache is
    whole on every rank (each writes the same c_kv and k_rope), the
    absorbed decode runs on the rank's heads and the prefill's kernel on
    H / M heads."""
    b, s, _ = x.shape
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    q_nope, q_rope = _mla_q(cfg, p, x, positions, tp)
    h = q_nope.shape[2]
    c_kv, k_rope = _mla_kv_compress(cfg, p, x, positions)
    c_kv = tpm.copy_to_region(c_kv, tp)
    k_rope = tpm.copy_to_region(k_rope, tp)
    if cache is not None:
        new_cache = _ring_write(cache, {"c_kv": c_kv, "k_rope": k_rope},
                                positions)
        c_all, r_all, k_pos = (new_cache["c_kv"], new_cache["k_rope"],
                               new_cache["pos"])
    else:
        c_all, r_all, k_pos, new_cache = c_kv, k_rope, positions, None

    if s == 1 and cache is not None:
        # absorbed decode: k_up folded into q, v_up into the output
        k_up = p["k_up"]["w"].reshape(cfg.kv_lora_rank, h, nope).float()
        v_up = p["v_up"]["w"].reshape(cfg.kv_lora_rank, h, vd).float()
        c_f = c_all.float()
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope.float(), k_up)
        scores = (torch.einsum("bshl,btl->bhst", q_lat, c_f)
                  + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                 r_all.float()))
        scores = scores / math.sqrt(nope + rope)
        scores = scores + _mask_bias(positions, k_pos, window)[:, None]
        w = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btl->bshl", w, c_f)
        out = torch.einsum("bshl,lhv->bshv", o_lat, v_up)
        out = out.to(x.dtype).reshape(b, s, h * vd)
    else:
        t = c_all.shape[1]
        k_nope = linear(p["k_up"], c_all).reshape(b, t, h, nope)
        v = linear(p["v_up"], c_all).reshape(b, t, h, vd)
        k = torch.cat([k_nope, r_all[:, :, None, :].expand(b, t, h, rope)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        if vd < nope + rope:
            v = torch.nn.functional.pad(v, (0, nope + rope - vd))
        out = sdpa(q, k, v, positions, k_pos, window=window, impl=impl)
        out = out[..., :vd].reshape(b, s, h * vd)
    return row_parallel(p["wo"], out, tp), new_cache


# =====================  unified entry  =====================

def init_attention(rng, cfg, dtype):
    if cfg.attention == "mla":
        return init_mla(rng, cfg, dtype)
    return init_gqa(rng, cfg, dtype)


def attention_forward(cfg, p, x, positions, *, window=0, cache=None,
                      impl="auto", tp=None):
    if cfg.attention == "mla":
        return mla_forward(cfg, p, x, positions, window=window, cache=cache,
                           impl=impl, tp=tp)
    return gqa_forward(cfg, p, x, positions, window=window, cache=cache,
                       impl=impl, tp=tp)


def init_cache(cfg, batch, capacity, dtype, device=None):
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, capacity, dtype, device)
    return init_kv_cache(cfg, batch, capacity, dtype, device)
