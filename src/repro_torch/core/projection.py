"""Orthogonal projection + adaptive scaling on the flat parameter layout —
the mathematical core of FedDPC (paper §4.1–4.2, Fig. 2); counterpart of
repro/core/projection.py.

The reference sums per-leaf partials over a pytree; here a parameter
vector is one flat f32 buffer (repro_torch.bridge), so every reduction is
one op over its last axis. A (K, N) client stack against an (N,) vector
broadcasts to (K,) results — the reference's ``vmap`` over clients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-12


def tree_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the flat parameter vector (last axis), f32."""
    return torch.sum(a.float() * b.float(), dim=-1)


def tree_sqnorm(a: torch.Tensor) -> torch.Tensor:
    return tree_vdot(a, a)


def tree_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(a))


def masked_client_mean(x: torch.Tensor,
                       client_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """f32 mean over the leading (client) axis of a (K, N) stack; with
    ``client_mask`` (K,) bool the mean runs over the True rows only."""
    if client_mask is None:
        return torch.mean(x.float(), dim=0)
    mf = client_mask.float()
    nvalid = torch.clamp(mf.sum(), min=1.0)
    return torch.sum(x.float() * mf[:, None], dim=0) / nvalid


def project_coefficient(delta: torch.Tensor, delta_prev: torch.Tensor
                        ) -> torch.Tensor:
    """coef such that Proj_{prev}(delta) = coef * prev. Zero-safe: when
    ||prev|| == 0 (round 1, Delta_0 -> 0) the projection is 0."""
    num = tree_vdot(delta, delta_prev)
    den = tree_sqnorm(delta_prev)
    return torch.where(den > EPS, num / torch.clamp(den, min=EPS),
                       torch.zeros_like(num))


def scalars_from_dots(dp: torch.Tensor, dd: torch.Tensor, pp: torch.Tensor,
                      lam: float) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The scalar half of ``projection_scalars``: from <d,prev>, ||d||²
    and ||prev||² (any matching shapes) to (coef, scale, diagnostics).
    ||resid||² = ||d||² - coef²||prev||² (Pythagoras) saves a pass."""
    zero = torch.zeros_like(dp)
    coef = torch.where(pp > EPS, dp / torch.clamp(pp, min=EPS), zero)
    norm_d = torch.sqrt(dd)
    sq_resid = torch.clamp(dd - coef * coef * pp, min=0.0)
    norm_r = torch.sqrt(sq_resid)
    scale = lam + norm_d / torch.clamp(norm_r, min=EPS)
    diag = {"coef": coef, "norm_delta": norm_d, "norm_resid": norm_r,
            "scale": scale,
            "cos_angle": torch.where(norm_d > EPS,
                                     coef * torch.sqrt(pp)
                                     / torch.clamp(norm_d, min=EPS), zero)}
    return coef, scale, diag


def projection_scalars(delta: torch.Tensor, delta_prev: torch.Tensor,
                       lam: float) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The reduction half of FedDPC's per-client modification: the three
    dots <d,prev>, ||d||², ||prev||² and everything derived from them.
    delta (N,) or (K, N); returns (coef, scale, diagnostics)."""
    dp = tree_vdot(delta, delta_prev)
    dd = tree_sqnorm(delta)
    pp = tree_sqnorm(delta_prev).expand_as(dp)
    return scalars_from_dots(dp, dd, pp, lam)
