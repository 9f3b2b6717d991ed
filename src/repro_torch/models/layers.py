"""Layer primitives (counterpart of repro/models/layers.py); this slice
carries GroupNorm."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_group_norm(groups: int, channels: int, dtype=torch.float32):
    return {"scale": torch.ones(channels, dtype=dtype),
            "bias": torch.zeros(channels, dtype=dtype)}


def group_norm(p, x: torch.Tensor, groups: int, eps: float = 1e-5
               ) -> torch.Tensor:
    """x (B, C, H, W) — the NCHW view the vision models work in; the
    reference normalizes its NHWC array over the same (H, W, C/groups)
    sets, with the biased variance, then applies per-channel scale and
    bias."""
    return F.group_norm(x.float(), groups, p["scale"], p["bias"],
                        eps).to(x.dtype)
