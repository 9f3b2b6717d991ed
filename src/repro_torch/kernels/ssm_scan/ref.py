"""Plain PyTorch version of the selective-scan kernel (counterpart of
repro/kernels/ssm_scan/ref.py): the sequential recurrence over time,
state (B, D_in, N) in f32,

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t
    y_t = sum_n c_t[n] * h_t[:, n] + d_skip * u_t

starting from ``h0`` (zeros when None), with the kernel's rounding step
for step (the sum over n as its pairwise tree). The kernel's fused
inputs are the Mamba mixer's own eager ops around the scan: dt = dt +
``dt_bias``, then ``softplus`` of it (``dt_softplus``), and y * silu(``z``)
in u's dtype. It keeps one (B, D_in, N) state
and a few step-sized temporaries, never the (B, S, D_in, N) tensors of
the reference model's associative scan: at Falcon-Mamba-7B's width those
are 4.3 GB each in f32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    exact for every x (torch's softplus returns x above its threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 dt_bias: Optional[torch.Tensor] = None,
                 dt_softplus: bool = False,
                 z: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B, S, D_in) f32 or bf16, dt (B, S, D_in) f32, b/c (B, S, N)
    f32, a (D_in, N) f32 (already negative), d_skip (D_in,) f32, h0
    (B, D_in, N) f32 or None, dt_bias (D_in,) f32 or None, z (B, S, D_in)
    in u's dtype or None -> (y (B, S, D_in) in u's dtype — y * silu(z)
    when z is given — and h_final (B, D_in, N) f32)."""
    if dt_bias is not None:
        dt = dt + dt_bias
    if dt_softplus:
        dt = softplus(dt)
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    uf = u.float()
    dtf = dt.float()
    h = (torch.zeros((bsz, d_in, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float().clone())
    ys = []
    for t in range(s):
        dt_t, u_t = dtf[:, t], uf[:, t]                      # (B, D_in)
        decay = torch.exp(dt_t[..., None] * a)               # (B, D_in, N)
        h = h * decay + (dt_t * u_t)[..., None] * b[:, t, None, :]
        ys.append(_sum_states(h * c[:, t, None, :]) + d_skip * u_t)
    # stacked, not written into a preallocated buffer: the training route
    # runs this under torch.func.vmap and autograd, which refuse an
    # in-place write of a batched value into an unbatched buffer
    y = torch.stack(ys, dim=1).to(u.dtype)
    if z is not None:
        y = y * F.silu(z)
    return y, h


def _sum_states(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree, zero-padded to a power of
    two (the kernel's order): the same f32 roundings on every device."""
    n = x.shape[-1]
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]
