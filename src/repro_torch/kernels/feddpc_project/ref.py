"""Plain PyTorch versions of the FedDPC server-step kernels, on the flat
(K, N) layout (counterparts of repro/kernels/feddpc_project/ref.py's
``dots_ref`` and ``batched_epilogue_ref``).

The CPU path runs these; on the card they are only the yardstick the
kernels are held against (tests, chip_smoke.py), never the path.
"""
from __future__ import annotations

import torch


def dots_ref(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d (K, N), p (N,) -> (K, 3) = [<d_j,p>, <d_j,d_j>, <p,p>] in f32."""
    df = d.float()
    pf = p.float()
    pp = torch.sum(pf * pf).expand(d.shape[0])
    return torch.stack([torch.sum(df * pf, dim=-1),
                        torch.sum(df * df, dim=-1), pp], dim=-1)


def batched_epilogue_ref(d: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
                         coefs: torch.Tensor, scales: torch.Tensor,
                         eta_g: float):
    """d (K, N), p/w (N,), coefs/scales (K,) -> (new_w, delta_t):
    delta_t = mean_j scale_j * (d_j - coef_j * p), new_w = w - eta_g *
    delta_t. delta_t stays f32 (it is server state)."""
    c = coefs.float()[:, None]
    s = scales.float()[:, None]
    dt = torch.mean(s * (d.float() - c * p.float()[None]), dim=0)
    new_w = (w.float() - eta_g * dt).to(w.dtype)
    return new_w, dt
