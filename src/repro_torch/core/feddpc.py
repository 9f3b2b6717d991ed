"""FedDPC server step (paper Algorithm 1, lines 15-19) on the flat layout;
counterpart of repro/core/feddpc.py.

Two passes over the (K, N) stack of client deltas:

  1. the reduction pass, ``ops.feddpc_dots``: <Δ_j,Δ_prev>, ||Δ_j||²,
     ||Δ_prev||² for every client in one launch (on the decoded stack
     when a codec is on);
  2. the scalar math (``projection.scalars_from_dots``, on device, no host
     read) and the mask folding;
  3. one fold: Δ_t = mean_j scale_j (Δ_j − coef_j Δ_prev) and
     w' = w − η_g Δ_t, through the kernel that fits the round, as the
     reference's ``kernel_fold`` picks its Pallas route:

       staleness weights  codec payload  kernel
       no                 no             feddpc_batched_epilogue
       yes                no             feddpc_buffer_fold
       no                 yes            feddpc_dequant_batched_epilogue
       yes                yes            feddpc_dequant_buffer_fold

``server_step_projection_only`` (the Fig. 6 ablation, ``feddpc_noscale``)
is the same two passes with every scale 1: ``feddpc_dots`` for the
coefficients, ``feddpc_batched_epilogue`` for the fold.

The device decides the route: CUDA tensors always go through the
kernels, CPU tensors through their plain versions. Server state is one
vector, ``delta_prev``.

On the model axis (``shard.model > 1``) every vector here is the rank's
shard of N_m columns: the gathered dots were summed over the model
ranks first, each fold runs on the shard, and the diagnostics' norm and
dot are model-summed (one collective).

Hierarchical edges (``edges=E``) and the multi-process round
(``shard``, core/round.RankShard) reshape only the fold, as the
reference's ``feddpc.py`` does on its edge path: the reduction-pass
scalars are per-row sums, so every rank (or edge) forms the same coefs
and scales from the whole cohort's dots, and the fold runs ONE kernel
launch per edge piece — the intersection of an edge's rows with the
rows at hand (sharding/rules.edge_pieces). A piece's Δ, weighted by its
row count over the padded cohort, is its share of Δ_t; the kernel's w'
is dropped. In a multi-process round the shares are summed over the
ranks (one all-reduce) and w' = w − η_g·Δ_t is taken from the sum. The
rows are padded to equal groups, so this mean of means is the flat mean
up to summation order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import projection as proj
from repro_torch.kernels.feddpc_project import ops as k_ops
from repro_torch.sharding.rules import edge_pieces


def init_state(params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Delta_0 -> 0: projection onto a zero vector is 0, so round 1 is
    two-sided-LR FedAvg scaled by lam + 1."""
    return {"delta_prev": torch.zeros_like(params, dtype=torch.float32)}


def _fold_mask(coefs: torch.Tensor, scales: torch.Tensor,
               client_mask: Optional[torch.Tensor]):
    """Fold the client mask into the fold's scalars: masked rows get
    scale = coef = 0 and the survivors renormalize by K/n_valid. Returns
    contiguous (coefs, scales) and the mean over the real rows."""
    if client_mask is None:
        diag_mean = torch.mean
    else:
        mf = client_mask.float()
        nvalid = torch.clamp(mf.sum(), min=1.0)
        coefs = coefs * mf
        scales = scales * mf * (mf.shape[0] / nvalid)

        def diag_mean(x):
            return torch.sum(x * mf) / nvalid
    return coefs.contiguous(), scales.contiguous(), diag_mean


def _folds(kernel_fold, params: torch.Tensor, k: int, eta_g: float,
           edges: Optional[int], shard):
    """(new_params, Δ_t) from ``kernel_fold(lo, hi, glo)`` -> (w', Δ) of
    the local rows [lo, hi) (global rows from glo): one launch over all
    K rows of a flat single-process round, else one launch per edge
    piece, the pieces' Δ weighted by their rows over the padded cohort,
    summed (over the ranks too, with ``shard``), and w' from the sum."""
    if shard is None and not (edges and edges > 1):
        return kernel_fold(0, k, 0)
    lo, rows = (0, k) if shard is None else (shard.lo, shard.rows)
    pieces = (edge_pieces(0, k, k, edges) if shard is None
              else shard.pieces)
    delta_t = None
    for a, b in pieces:
        part = kernel_fold(a - lo, b - lo, a)[1].mul_((b - a) / rows)
        delta_t = part if delta_t is None else delta_t.add_(part)
    if shard is not None:
        shard.all_sum(delta_t)
    new_params = (params.float() - eta_g * delta_t).to(params.dtype)
    return new_params, delta_t


def server_step(state: Dict[str, torch.Tensor], params: torch.Tensor,
                deltas: torch.Tensor, eta_g: float, lam: float = 1.0,
                client_mask: Optional[torch.Tensor] = None,
                staleness_weights: Optional[torch.Tensor] = None,
                encoded: Optional[Dict[str, torch.Tensor]] = None,
                leaf_offsets: Optional[torch.Tensor] = None,
                edges: Optional[int] = None, shard=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """One FedDPC aggregation. params (N,), deltas (K, N) f32 contiguous,
    Δ_j = (w_{t-1} − w_j)/η_l; client_mask (K,) bool marks the real rows.

    The per-client transform scale_j (d_j − coef_j prev) is linear in
    (scale_j, coef_j), so the mask folds exactly into the scalars: masked
    rows get scale = coef = 0 and the survivors renormalize by K/n_valid,
    leaving the mean-over-K fold unchanged.

    staleness_weights (K,) f32 are the buffered-async discounts: each
    weight multiplies its row's adaptive SCALE inside the fold, so coef
    and the diagnostics are computed on the raw delta. At staleness 0
    every weight is 1.0 and the step is the synchronous one.

    encoded is the codec payload {"q", "scale", "zero"} whose dequant
    (leaves at ``leaf_offsets``) reproduces ``deltas`` exactly: the dots
    run on ``deltas``, the fold reads the int8/bf16 payload instead.

    ``edges`` folds each edge's rows with a launch of its own;
    ``shard`` holds this rank's rows of a multi-process round: ``deltas``
    (and ``encoded``) are its rows, ``client_mask`` and
    ``staleness_weights`` the whole cohort's, and the dots are the
    gathered ``shard.dots`` (see the module docstring).

    Returns (new_params, new_state, diagnostics) — the diagnostics are
    0-d device tensors.
    """
    if encoded is not None and leaf_offsets is None:
        raise ValueError("server_step: an encoded payload needs the "
                         "leaf_offsets of its layout")
    delta_prev = state["delta_prev"]
    dots = (k_ops.feddpc_dots(deltas, delta_prev) if shard is None
            else shard.dots)
    coefs, scales, diag = proj.scalars_from_dots(
        dots[:, 0], dots[:, 1], dots[:, 2], lam)
    coefs, scales, diag_mean = _fold_mask(coefs, scales, client_mask)
    wgt = (None if staleness_weights is None
           else staleness_weights.to(device=deltas.device,
                                     dtype=torch.float32).contiguous())

    def kernel_fold(lo, hi, glo):
        """The fold of local rows [lo, hi), global rows from glo."""
        gsl = slice(glo, glo + hi - lo)
        c, s = coefs[gsl], scales[gsl]
        w = None if wgt is None else wgt[gsl]
        if encoded is None and w is None:
            return k_ops.feddpc_batched_epilogue(
                deltas[lo:hi], delta_prev, params, c, s, eta_g)
        if encoded is None:
            return k_ops.feddpc_buffer_fold(
                deltas[lo:hi], delta_prev, params, c, s, w, eta_g)
        payload = (encoded["q"][lo:hi], encoded["scale"][lo:hi],
                   encoded["zero"][lo:hi], leaf_offsets, delta_prev, params,
                   c, s)
        if w is None:
            return k_ops.feddpc_dequant_batched_epilogue(*payload, eta_g)
        return k_ops.feddpc_dequant_buffer_fold(*payload, w, eta_g)

    new_params, delta_t = _folds(kernel_fold, params, deltas.shape[0],
                                 eta_g, edges, shard)
    sq, gdp = proj.model_summed(torch.stack(
        [proj.tree_sqnorm(delta_t), proj.tree_vdot(delta_t, delta_prev)]),
        shard)
    diagnostics = {
        "mean_coef": diag_mean(diag["coef"]),
        "mean_cos_angle": diag_mean(diag["cos_angle"]),
        "mean_scale": diag_mean(diag["scale"]),
        "mean_norm_delta": diag_mean(diag["norm_delta"]),
        "norm_global_update": torch.sqrt(sq),
        # orthogonality invariant: <Delta_t, Delta_{t-1}> ~ 0 after round 1
        "global_dot_prev": gdp,
    }
    return new_params, {"delta_prev": delta_t}, diagnostics


def server_step_projection_only(state: Dict[str, torch.Tensor],
                                params: torch.Tensor, deltas: torch.Tensor,
                                eta_g: float,
                                client_mask: Optional[torch.Tensor] = None,
                                edges: Optional[int] = None, shard=None
                                ) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """Ablation: orthogonal projection WITHOUT adaptive scaling (paper
    Fig. 6): Δ_t = mean_j (Δ_j − coef_j Δ_prev), w' = w − η_g Δ_t — the
    batched epilogue with every scale 1. The mask folds into (coef,
    scale) as in ``server_step``, so the mean over the real rows is the
    reference's ``masked_client_mean`` up to summation order; ``edges``
    and ``shard`` fold by pieces as ``server_step`` does."""
    delta_prev = state["delta_prev"]
    dots = (k_ops.feddpc_dots(deltas, delta_prev) if shard is None
            else shard.dots)
    coefs = proj.scalars_from_dots(dots[:, 0], dots[:, 1], dots[:, 2],
                                   lam=1.0)[0]
    coefs, scales, _ = _fold_mask(coefs, torch.ones_like(coefs),
                                  client_mask)

    def kernel_fold(lo, hi, glo):
        gsl = slice(glo, glo + hi - lo)
        return k_ops.feddpc_batched_epilogue(
            deltas[lo:hi], delta_prev, params, coefs[gsl], scales[gsl],
            eta_g)

    new_params, delta_t = _folds(kernel_fold, params, deltas.shape[0],
                                 eta_g, edges, shard)
    return new_params, {"delta_prev": delta_t}, {
        "norm_global_update": proj.global_norm(delta_t, shard)}
