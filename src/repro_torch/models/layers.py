"""Layer primitives (counterpart of repro/models/layers.py): GroupNorm for
the vision models; linear, norms, MLPs and RoPE for the decoders.

Parameters are plain dicts of tensors in the reference's layouts (a
linear weight is (d_in, d_out), applied as ``x @ w``), so the reference's
params carry across leaf for leaf. Initializers draw from an explicit
``torch.Generator`` on its own device, with the reference's
distributions (not its numbers: the two generators differ).
"""
from __future__ import annotations

import math
from typing import Optional

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


# ---------------- linear ----------------

def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, scale: Optional[float] = None):
    p = {"w": _dense_init(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------- norms ----------------

def init_norm(kind: str, d: int, dtype, device=None):
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis; statistics in f32, the
    result cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    return F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


# ---------------- MLP ----------------

def init_mlp(gen: torch.Generator, kind: str, d_model: int, d_ff: int,
             dtype, bias: bool = False):
    if kind == "swiglu":
        return {"gate": init_linear(gen, d_model, d_ff, dtype, bias),
                "up": init_linear(gen, d_model, d_ff, dtype, bias),
                "down": init_linear(gen, d_ff, d_model, dtype, bias)}
    return {"up": init_linear(gen, d_model, d_ff, dtype, bias),
            "down": init_linear(gen, d_ff, d_model, dtype, bias)}


def apply_mlp(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return linear(p["down"], F.silu(linear(p["gate"], x))
                      * linear(p["up"], x))
    h = linear(p["up"], x)
    if kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return linear(p["down"], h)


# ---------------- RoPE ----------------

def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (..., S) int -> cos, sin (..., S, head_dim/2) f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2). The half-split
    form (x1 = x[..., :D/2], x2 = x[..., D/2:]), computed in f32 and cast
    back to x's dtype."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos_ - xf2 * sin_, xf2 * cos_ + xf1 * sin_],
                     dim=-1).to(x.dtype)
