"""Whisper-style encoder-decoder backbone (counterpart of
repro/models/encdec.py).

The mel-spectrogram and conv feature extractor are stubbed, as in the
reference: the model consumes precomputed frame embeddings (B,
encoder_seq_len, d_model) (models/frontend.audio_frame_stub).

Encoder: bidirectional self-attention + MLP over the frames plus the
interleaved sinusoidal table (layers.sinusoidal_positions). Decoder:
causal self-attention (against a KV cache when serving) + cross-attention
over the encoder output + MLP, with the decoder's own sinusoidal
positions — concatenated [sin, cos] over d_model / 2 frequencies, a
different convention from the encoder's, kept as the reference has it.
The reference's docstring says the cross K/V are computed once at
prefill and carried; its code recomputes them from ``enc_out`` at every
decode step, and so does the port (ROADMAP Queue 2).

All attention goes through ``attention.sdpa`` (on the card the flash
kernel): the encoder and the cross-attention pass every query the
position T_enc, so every key is visible (T_enc keys at 0..T_enc - 1).

Parameters come in either of two trees, as in transformer.py:

  serving  {"embed", "encoder": [layer, ...], "enc_norm", "decoder":
           [layer, ...], "final_norm", "lm_head"} — ``init_encdec`` from
           a torch.Generator;
  training the reference's own: "encoder" and "decoder" are single layer
           trees whose leaves carry a leading layer axis (its ``vmap``
           of the layer init) — ``init_encdec`` from a jax_prng key, the
           reference's numbers; the forward reads layer i as views.

Decoder states are a list of per-layer GQA caches (attention.init_cache).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, init_linear,
                                       init_mlp, init_norm, linear, normal,
                                       rng_device, sinusoidal_positions,
                                       split_rng)
from repro_torch.models.transformer import _map, _stack_trees


def _init_enc_layer(rng, cfg, dtype):
    dev = rng_device(rng)
    k1, k2 = split_rng(rng, 2)
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "attn": attn_mod.init_gqa(k1, cfg, dtype),
        "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "mlp": init_mlp(k2, cfg.mlp, cfg.d_model, cfg.d_ff, dtype,
                        cfg.mlp_bias),
    }


def _init_dec_layer(rng, cfg, dtype):
    dev = rng_device(rng)
    k1, k2, k3 = split_rng(rng, 3)
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "self_attn": attn_mod.init_gqa(k1, cfg, dtype),
        "norm_x": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "cross_attn": attn_mod.init_gqa(k2, cfg, dtype),
        "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "mlp": init_mlp(k3, cfg.mlp, cfg.d_model, cfg.d_ff, dtype,
                        cfg.mlp_bias),
    }


def init_encdec(cfg, rng, dtype=None):
    """Parameters with the reference's distributions. ``rng`` a
    torch.Generator: the serving tree on its device. ``rng`` a
    ``core.jax_prng`` key: the reference's tree and numbers
    (``split(key, 6)`` into embed, encoder, decoder and head; the encoder
    and decoder keys split once more, a key a layer). ``rng="meta"``: the
    reference's tree on the meta device."""
    dtype = dtype or getattr(torch, cfg.dtype)
    dev = rng_device(rng)
    ks = split_rng(rng, 6)
    if isinstance(rng, torch.Generator):
        encoder = [_init_enc_layer(rng, cfg, dtype)
                   for _ in range(cfg.encoder_layers)]
        decoder = [_init_dec_layer(rng, cfg, dtype)
                   for _ in range(cfg.num_layers)]
    else:
        encoder = _stack_trees([_init_enc_layer(k, cfg, dtype) for k in
                                split_rng(ks[1], cfg.encoder_layers)])
        decoder = _stack_trees([_init_dec_layer(k, cfg, dtype) for k in
                                split_rng(ks[2], cfg.num_layers)])
    return {
        "embed": normal(ks[0], (cfg.vocab_size, cfg.d_model),
                        mul=0.02).to(dtype),
        "encoder": encoder,
        "enc_norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "decoder": decoder,
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "lm_head": init_linear(ks[3], cfg.d_model, cfg.vocab_size, dtype),
    }


def _layers(tree, n: int) -> List:
    """A list of per-layer trees, from a list or from one tree of stacked
    leaves (views ``leaf[i]``)."""
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [_map(lambda x, i=i: x[i], tree) for i in range(n)]


def _split_heads(cfg, p, x, kv_src):
    """q from x, k and v from kv_src, each (B, S, heads, HD)."""
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(*x.shape[:2], cfg.num_heads, hd)
    k = linear(p["wk"], kv_src).reshape(*kv_src.shape[:2],
                                        cfg.num_kv_heads, hd)
    v = linear(p["wv"], kv_src).reshape(*kv_src.shape[:2],
                                        cfg.num_kv_heads, hd)
    return q, k, v


def _all_visible(b: int, s: int, t: int, device):
    """(q_pos (B, s) all t, k_pos (B, t) = 0..t-1): every key visible."""
    q_pos = torch.full((b, s), t, dtype=torch.int32, device=device)
    k_pos = torch.arange(t, dtype=torch.int32, device=device)[None].expand(
        b, t)
    return q_pos, k_pos


def encode(cfg, params, frames, attn_impl="auto"):
    """frames (B, T_enc, D), the stubbed conv output -> (B, T_enc, D)."""
    b, t, d = frames.shape
    x = frames + sinusoidal_positions(t, d).to(device=frames.device,
                                               dtype=frames.dtype)[None]
    q_pos, k_pos = _all_visible(b, t, t, frames.device)
    for lp in _layers(params["encoder"], cfg.encoder_layers):
        h = apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = _split_heads(cfg, lp["attn"], h, h)
        o = attn_mod.sdpa(q, k, v, q_pos, k_pos, impl=attn_impl)
        x = x + linear(lp["attn"]["wo"], o.reshape(b, t, -1))
        h2 = apply_norm(cfg.norm, lp["norm2"], x)
        x = x + apply_mlp(cfg.mlp, lp["mlp"], h2)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _cross_attention(cfg, lp, x, enc_out, attn_impl):
    b, s, _ = x.shape
    q, k, v = _split_heads(cfg, lp, x, enc_out)
    q_pos, k_pos = _all_visible(b, s, enc_out.shape[1], x.device)
    o = attn_mod.sdpa(q, k, v, q_pos, k_pos, impl=attn_impl)
    return linear(lp["wo"], o.reshape(b, s, -1))


def decoder_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (B, S) -> (B, S, d) f32: [sin, cos] of pos / 10000^(i /
    (d/2)), concatenated (the decoder's convention)."""
    half = d // 2
    inv = 1.0 / torch.pow(10000.0, torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def decode(cfg, params, tokens, enc_out, positions=None, *,
           states: Optional[List] = None, window: int = 0,
           attn_impl="auto"):
    """tokens (B, S), enc_out (B, T_enc, D); ``states`` the per-layer
    self-attention caches (init_decoder_states; written in place), None
    for a teacher-forced pass. Returns (logits, new_states)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = params["embed"][tokens]
    x = x + decoder_positions(positions, cfg.d_model).to(x.dtype)
    new_states = None if states is None else []
    for i, lp in enumerate(_layers(params["decoder"], cfg.num_layers)):
        h = apply_norm(cfg.norm, lp["norm1"], x)
        att, nst = attn_mod.gqa_forward(
            cfg, lp["self_attn"], h, positions, window=window,
            cache=None if states is None else states[i], impl=attn_impl)
        x = x + att
        hx = apply_norm(cfg.norm, lp["norm_x"], x)
        x = x + _cross_attention(cfg, lp["cross_attn"], hx, enc_out,
                                 attn_impl)
        h2 = apply_norm(cfg.norm, lp["norm2"], x)
        x = x + apply_mlp(cfg.mlp, lp["mlp"], h2)
        if states is not None:
            new_states.append(nst)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return linear(params["lm_head"], x), new_states


def init_decoder_states(cfg, batch, capacity, dtype=None,
                        device=None) -> List:
    dtype = dtype or getattr(torch, cfg.dtype)
    return [attn_mod.init_kv_cache(cfg, batch, capacity, dtype, device)
            for _ in range(cfg.num_layers)]


def encdec_loss_fn(cfg, params, batch, attn_impl="auto"):
    """Teacher-forced cross entropy of {"frames", "tokens", "labels"}
    (-100 = ignore), logits in f32, the mean over valid labels. On the
    training route: "auto" attention is the reference's plain rule
    (``sdpa(impl="plain")``) on every device, as transformer.loss_fn."""
    impl = "plain" if attn_impl == "auto" else attn_impl
    enc_out = encode(cfg, params, batch["frames"], impl)
    logits, _ = decode(cfg, params, batch["tokens"], enc_out, attn_impl=impl)
    logits = logits.float()
    labels = batch["labels"]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum() / torch.clamp(valid.sum(), min=1)
