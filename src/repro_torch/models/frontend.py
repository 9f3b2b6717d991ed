"""Modality frontend stubs (counterpart of repro/models/frontend.py).

The vision tower (ViT/SigLIP + projector) and the audio codec (mel +
conv) are represented by functions that produce embeddings of exactly
the shape the real frontend would emit, drawn from an explicit
``torch.Generator`` on its device (the reference draws from a PRNG key;
the numbers differ, the distribution does not).
"""
from __future__ import annotations

import torch


def _stub(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02
            ).to(dtype)


def vision_patch_stub(gen: torch.Generator, batch: int, num_patches: int,
                      d_model: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Pre-projected anyres patch embeddings a LLaVA-NeXT vision tower +
    mm-projector would produce: (B, P, D) on ``gen``'s device."""
    return _stub(gen, (batch, num_patches, d_model), dtype)


def audio_frame_stub(gen: torch.Generator, batch: int, frames: int,
                     d_model: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Post-conv (stride-2) mel frame embeddings a Whisper conv frontend
    would produce: (B, T_enc, D) on ``gen``'s device."""
    return _stub(gen, (batch, frames, d_model), dtype)
