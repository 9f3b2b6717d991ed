"""Batched serving driver (counterpart of repro/launch/serve.py): prefill a
batch of prompts, then decode greedily token by token against the
per-layer KV caches or SSM states — on the card by default, every
attention call through the flash-attention kernel and every selective
scan through the ssm_scan kernel:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b

``--size full`` runs the full-size config (random weights from
``--seed``), ``--dtype bfloat16`` the bf16 model, and ``--device cpu``
the CPU (plain attention and scan); without it the script raises when
CUDA is absent. The port carries the dense GQA decoders and the pure-SSM
Falcon-Mamba; encoder-decoder, VLM, MoE, MLA and hybrid serving come
with later slices.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.api import resolve_device
from repro_torch.models import transformer as tf

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg, batch, prompt_len, gen, seed=0, *, device="cuda",
             dtype=torch.float32, attn_impl="auto", ssm_impl="auto",
             prompts=None, params=None):
    """Greedy generation of ``gen`` tokens for ``batch`` prompts of
    ``prompt_len`` tokens: one prefill (logits of the last position),
    then ``gen - 1`` decode steps at positions prompt_len + i, in caches
    of capacity prompt_len + gen (an SSM layer carries its fixed-size
    state instead). ``params`` (from ``tf.init_lm``, on ``device``) and
    ``prompts`` (B, prompt_len) are drawn from ``seed`` when not given.
    ``attn_impl`` and ``ssm_impl`` go to ``tf.lm_forward``. Returns
    (tokens (B, gen) int64, stats)."""
    if cfg.is_encoder_decoder or cfg.modality != "text":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and VLM "
                                  "serving are not ported to repro_torch "
                                  "yet (ROADMAP Queue 1 item 14); it serves "
                                  "dense GQA decoders and pure-SSM stacks")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # the reference is f32
    rng = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = tf.init_lm(cfg, rng, dtype)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=rng, device=device)
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts must be ({batch}, {prompt_len}), got "
                         f"{tuple(prompts.shape)}")
    states = tf.init_states(cfg, batch, prompt_len + gen, dtype, device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, states, _ = tf.lm_forward(cfg, params, prompts.to(device),
                                          states=states, attn_impl=attn_impl,
                                          ssm_impl=ssm_impl,
                                          logits_slice_last=True)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch, 1), prompt_len + i, dtype=torch.int32,
                             device=device)
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
    tokens, stats = serve_lm(cfg, args.batch, args.prompt_len, args.gen,
                             args.seed, device=args.device,
                             dtype=DTYPES[args.dtype])
    print(f"[{args.arch}] generated {tuple(tokens.shape)} tokens on "
          f"{args.device}; stats={stats}")
    print("sample:", tokens[0].tolist())
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise RuntimeError("generated token ids outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
