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


def model_summed(x: torch.Tensor, shard=None) -> torch.Tensor:
    """A shard's partial sums over the model axis (core/round.RankShard:
    each model rank holds N_m of the N columns); ``x`` itself without
    it."""
    return x if shard is None else shard.model_sum(x)


def global_norm(a: torch.Tensor, shard=None) -> torch.Tensor:
    """||a|| over the whole flat vector, ``a`` one rank's shard of it on
    the model axis."""
    return torch.sqrt(model_summed(tree_sqnorm(a), shard))


def tree_nonfinite_count(a: torch.Tensor) -> torch.Tensor:
    """Number of NaN/Inf entries over the flat vector (last axis), as f32
    — the update guard's validity reduction; on the card the guard takes
    it from ``feddpc_guard_dots`` in the same pass as ||Δ||²."""
    return torch.sum(~torch.isfinite(a), dim=-1).float()


def masked_client_mean(x: torch.Tensor,
                       client_mask: Optional[torch.Tensor] = None, *,
                       edges: Optional[int] = None, shard=None
                       ) -> torch.Tensor:
    """f32 mean over the leading (client) axis of a (K, N) stack; with
    ``client_mask`` (K,) bool the mean runs over the True rows only.

    ``edges=E`` computes the same mean as the reference's two-level fold:
    the K rows split into E equal contiguous groups, each edge reduces
    its group to a partial sum (and a live count), and the server
    combines the E partials — equal to the flat mean up to summation
    order, because the mask is a per-row weight.

    ``shard`` (core/round.RankShard, or a BufferShard of an async fold)
    makes it the multi-process mean: x holds this rank's rows of the
    padded cohort (or its held arrivals of the buffer, none at all
    maybe), ``client_mask`` the whole cohort's, and the rank's partial
    sum over its rows is summed over the ranks (one all-reduce). Equal groups make the mean of the
    edge means the flat mean, so the edges change only the order of the
    sums there."""
    if shard is not None:
        if client_mask is None:
            part = torch.sum(x.float(), dim=0) / shard.rows
        else:
            mf = client_mask.float()
            nvalid = torch.clamp(mf.sum(), min=1.0)
            part = torch.sum(x.float() * shard.local_rows(mf)[:, None],
                             dim=0) / nvalid
        return shard.all_sum(part)
    if edges is not None and int(edges) > 1:
        e = int(edges)
        k = x.shape[0]
        if k % e:
            raise ValueError(f"edges={e} must divide the client axis ({k})")
        xs = x.float().reshape(e, k // e, -1)
        if client_mask is None:
            return torch.mean(torch.mean(xs, dim=1), dim=0)
        w = client_mask.float().reshape(e, k // e)
        part = torch.sum(xs * w[:, :, None], dim=1)         # edge sums
        live = torch.sum(w, dim=1)                           # edge counts
        return torch.sum(part, dim=0) / torch.clamp(torch.sum(live),
                                                    min=1.0)
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


def project_and_scale(delta: torch.Tensor, delta_prev: torch.Tensor,
                      lam: float, use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, dict]:
    """Paper Algorithm 1 lines 17–17b for ONE client's flat delta (N,):

        resid  = delta - Proj_{delta_prev}(delta)
        scaled = (lam + ||delta|| / ||resid||) * resid

    Returns (scaled residual in delta's dtype, diagnostics). The
    epilogue is ``feddpc_fused_epilogue``: its kernel for CUDA tensors,
    its plain version for CPU tensors — the tensors' device decides, as
    in ``feddpc.server_step``; ``use_kernel`` is accepted for the
    reference's signature and changes nothing."""
    # imported here: ops imports this module for scalars_from_dots
    from repro_torch.kernels.feddpc_project import ops as k_ops
    del use_kernel
    coef, scale, diag = projection_scalars(delta, delta_prev, lam)
    scaled = k_ops.feddpc_fused_epilogue(delta, delta_prev.float(), coef,
                                         scale)
    return scaled, diag
