"""Batched serving driver (counterpart of repro/launch/serve.py): prefill a
batch of prompts, then decode greedily token by token against the
per-layer KV caches or SSM states — on the card by default, every
attention call through the flash-attention kernel (but MLA's absorbed
decode, plain f32 einsums as in the reference) and every selective scan
through the ssm_scan kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base

``--size full`` runs the full-size config (random weights from
``--seed``), ``--dtype bfloat16`` the bf16 model, and ``--device cpu``
the CPU (plain attention and scan); without it the script raises when
CUDA is absent. Every architecture of the reference serves: the dense
GQA decoders, MLA + MoE (DeepSeek-V2), GQA + MoE (Kimi-K2), the pure-SSM
Falcon-Mamba, the hybrid Jamba, LLaVA-NeXT's VLM trunk (a zero patch
prefix, the stub's, before each prompt) and the encoder-decoder
Whisper (``serve_encdec``: random frames, greedy from BOS).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.api import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import sinusoidal_positions

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg, batch, prompt_len, gen, seed=0, *, device="cuda",
             dtype=torch.float32, attn_impl="auto", ssm_impl="auto",
             prompts=None, params=None):
    """Greedy generation of ``gen`` tokens for ``batch`` prompts of
    ``prompt_len`` tokens: one prefill (logits of the last position),
    then ``gen - 1`` decode steps at positions P + prompt_len + i, in
    caches of capacity P + prompt_len + gen (an SSM layer carries its
    fixed-size state instead). P is a VLM's ``num_patches`` — its prefill
    prepends P zero patch embeddings, as the reference's — else 0. The
    reference sizes a VLM's cache prompt_len + gen and so overwrites its
    first patches while decoding; the port's holds them all (ROADMAP
    Queue 3). ``params`` (from ``tf.init_lm``, on ``device``) and
    ``prompts`` (B, prompt_len) are drawn from ``seed`` when not given.
    ``attn_impl`` and ``ssm_impl`` go to ``tf.lm_forward``. Returns
    (tokens (B, gen) int64, stats)."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder serves through "
                         "serve_encdec")
    device, rng = _device_and_rng(device, seed)
    if params is None:
        params = tf.init_lm(cfg, rng, dtype)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=rng, device=device)
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts must be ({batch}, {prompt_len}), got "
                         f"{tuple(prompts.shape)}")
    patches = cfg.num_patches if cfg.modality == "vision" else 0
    embeds = (torch.zeros((batch, patches, cfg.d_model), dtype=dtype,
                          device=device) if patches else None)
    states = tf.init_states(cfg, batch, patches + prompt_len + gen, dtype,
                            device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, states, _ = tf.lm_forward(cfg, params, prompts.to(device),
                                          embeds=embeds, states=states,
                                          attn_impl=attn_impl,
                                          ssm_impl=ssm_impl,
                                          logits_slice_last=True)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch, 1), patches + prompt_len + i,
                             dtype=torch.int32, device=device)
            logits, states, _ = tf.lm_forward(cfg, params, tok,
                                              positions=pos, states=states,
                                              attn_impl=attn_impl,
                                              ssm_impl=ssm_impl,
                                              logits_slice_last=True)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode,
                    "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def _device_and_rng(device, seed):
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # the reference is f32
    return device, torch.Generator(device=device).manual_seed(seed)


def serve_encdec(cfg, batch, gen, seed=0, *, device="cuda",
                 dtype=torch.float32, attn_impl="auto", params=None,
                 frames=None):
    """Greedy transcription of ``batch`` clips: encode the frames once,
    then ``gen`` decode steps from BOS (token 0) at positions 0..gen-1
    in self-attention caches of capacity gen + 1; each step attends
    across to the encoder output (its K/V recomputed a step, as the
    reference's code does). ``params`` (from ``encdec.init_encdec``, on
    ``device``) and ``frames`` (B, encoder_seq_len, d_model), the stubbed
    conv output, are drawn from ``seed`` when not given. Returns (tokens
    (B, gen) int64, stats)."""
    device, rng = _device_and_rng(device, seed)
    if params is None:
        params = encdec_mod.init_encdec(cfg, rng, dtype)
    if frames is None:
        frames = torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                             generator=rng, device=device).to(dtype)
    want = (batch, cfg.encoder_seq_len, cfg.d_model)
    if tuple(frames.shape) != want:
        raise ValueError(f"frames must be {want}, got {tuple(frames.shape)}")
    states = encdec_mod.init_decoder_states(cfg, batch, gen + 1, dtype,
                                            device)
    # the encoder's sinusoid table is built once per shape on the host,
    # element by element: build it before the timed window
    sinusoidal_positions(cfg.encoder_seq_len, cfg.d_model)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        enc_out = encdec_mod.encode(cfg, params, frames.to(device),
                                    attn_impl)
        _sync(device)
        t_encode = time.perf_counter() - t0
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        out = []
        for i in range(gen):
            pos = torch.full((batch, 1), i, dtype=torch.int32, device=device)
            logits, states = encdec_mod.decode(cfg, params, tok, enc_out,
                                               positions=pos, states=states,
                                               attn_impl=attn_impl)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(device)
        t_total = time.perf_counter() - t0
    t_decode = t_total - t_encode
    return torch.cat(out, dim=1), {
        "encode_s": t_encode, "decode_s": t_decode, "total_s": t_total,
        "tok_per_s": batch * gen / max(t_decode, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.size == "smoke")
    kw = {"device": args.device, "dtype": DTYPES[args.dtype]}
    if cfg.is_encoder_decoder:
        tokens, stats = serve_encdec(cfg, args.batch, args.gen, args.seed,
                                     **kw)
    else:
        tokens, stats = serve_lm(cfg, args.batch, args.prompt_len, args.gen,
                                 args.seed, **kw)
    print(f"[{args.arch}] generated {tuple(tokens.shape)} tokens on "
          f"{args.device}; stats={stats}")
    print("sample:", tokens[0].tolist())
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise RuntimeError("generated token ids outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
