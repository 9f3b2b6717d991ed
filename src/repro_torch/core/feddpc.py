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

The device decides the route: CUDA tensors always go through the
kernels, CPU tensors through their plain versions. Server state is one
vector, ``delta_prev``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import projection as proj
from repro_torch.kernels.feddpc_project import ops as k_ops


def init_state(params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Delta_0 -> 0: projection onto a zero vector is 0, so round 1 is
    two-sided-LR FedAvg scaled by lam + 1."""
    return {"delta_prev": torch.zeros_like(params, dtype=torch.float32)}


def server_step(state: Dict[str, torch.Tensor], params: torch.Tensor,
                deltas: torch.Tensor, eta_g: float, lam: float = 1.0,
                client_mask: Optional[torch.Tensor] = None,
                staleness_weights: Optional[torch.Tensor] = None,
                encoded: Optional[Dict[str, torch.Tensor]] = None,
                leaf_offsets: Optional[torch.Tensor] = None
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

    Returns (new_params, new_state, diagnostics) — the diagnostics are
    0-d device tensors.
    """
    if encoded is not None and leaf_offsets is None:
        raise ValueError("server_step: an encoded payload needs the "
                         "leaf_offsets of its layout")
    delta_prev = state["delta_prev"]
    dots = k_ops.feddpc_dots(deltas, delta_prev)
    coefs, scales, diag = proj.scalars_from_dots(
        dots[:, 0], dots[:, 1], dots[:, 2], lam)
    if client_mask is None:
        diag_mean = torch.mean
    else:
        mf = client_mask.float()
        nvalid = torch.clamp(mf.sum(), min=1.0)
        coefs = coefs * mf
        scales = scales * mf * (mf.shape[0] / nvalid)

        def diag_mean(x):
            return torch.sum(x * mf) / nvalid
    coefs, scales = coefs.contiguous(), scales.contiguous()
    wgt = (None if staleness_weights is None
           else staleness_weights.to(device=deltas.device,
                                     dtype=torch.float32).contiguous())
    if encoded is None and wgt is None:
        new_params, delta_t = k_ops.feddpc_batched_epilogue(
            deltas, delta_prev, params, coefs, scales, eta_g)
    elif encoded is None:
        new_params, delta_t = k_ops.feddpc_buffer_fold(
            deltas, delta_prev, params, coefs, scales, wgt, eta_g)
    else:
        payload = (encoded["q"], encoded["scale"], encoded["zero"],
                   leaf_offsets, delta_prev, params, coefs, scales)
        if wgt is None:
            new_params, delta_t = k_ops.feddpc_dequant_batched_epilogue(
                *payload, eta_g)
        else:
            new_params, delta_t = k_ops.feddpc_dequant_buffer_fold(
                *payload, wgt, eta_g)
    diagnostics = {
        "mean_coef": diag_mean(diag["coef"]),
        "mean_cos_angle": diag_mean(diag["cos_angle"]),
        "mean_scale": diag_mean(diag["scale"]),
        "mean_norm_delta": diag_mean(diag["norm_delta"]),
        "norm_global_update": proj.tree_norm(delta_t),
        # orthogonality invariant: <Delta_t, Delta_{t-1}> ~ 0 after round 1
        "global_dot_prev": proj.tree_vdot(delta_t, delta_prev),
    }
    return new_params, {"delta_prev": delta_t}, diagnostics
