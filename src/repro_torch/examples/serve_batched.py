"""Batched multi-architecture serving example (counterpart of the
reference's examples/serve_batched.py): prefill + decode a batch of
requests against three architecture families — dense GQA
(StarCoder2-3B), pure SSM (Falcon-Mamba-7B) and MoE + MLA
(DeepSeek-V2) — through the same serve API, at their SMOKE sizes.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

On the card every prefill attention call is the flash-attention kernel
and every scan the ssm_scan kernel; MLA decodes in its absorbed form
(plain einsums over the compressed cache, as in the reference).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve_lm

ARCHS = ("starcoder2-3b", "falcon-mamba-7b", "deepseek-v2-236b")
BATCH, PROMPT_LEN, GEN = 4, 24, 12


def main(argv=None):
    """Serves each of ARCHS and prints the reference example's lines;
    returns {arch: (tokens, stats)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        tokens, stats = serve_lm(cfg, batch=BATCH, prompt_len=PROMPT_LEN,
                                 gen=GEN, device=args.device)
        print(f"{arch:24s} [{cfg.arch_type:6s}] -> {tuple(tokens.shape)} "
              f"tokens, {stats['tok_per_s']:.1f} tok/s (prefill "
              f"{stats['prefill_s']:.2f}s)")
        if tuple(tokens.shape) != (BATCH, GEN):
            raise RuntimeError(f"{arch}: tokens {tuple(tokens.shape)}, "
                               f"expected {(BATCH, GEN)}")
        out[arch] = tokens, stats
    print("\nall three families served through one API (explicit "
          "cache/state pytrees; ring-buffer KV for dense, O(1) state for "
          "SSM, compressed-latent cache for MLA).")
    return out


if __name__ == "__main__":
    main()
