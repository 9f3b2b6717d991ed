"""Plain PyTorch versions of the FedDPC server-step kernels, on the flat
(K, N) layout (counterparts of repro/kernels/feddpc_project/ref.py's
``dots_ref``, ``guard_dots_ref``, ``epilogue_ref``,
``batched_epilogue_ref``, ``buffer_fold_ref``, ``dequant_ref``, the two
dequant folds and ``project_and_scale_flat_ref``).

The dequant folds read the codec's flat payload: q (K, N) int8 or bf16
and one (scale, zero) pair per client and leaf, qscale/qzero (K, L),
with the leaves' columns given by ``leaf_offsets`` (L+1,) int64 — 0,
then each leaf's end, N last.

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


def guard_dots_ref(d: torch.Tensor, p=None) -> torch.Tensor:
    """d (K, N), p (N,) or None -> (K, 4) = [<d~,p>, <d~,d~>, <p,p>,
    nonfinite(d)] in f32, d~ being d with its non-finite entries zeroed.
    Without p, columns 0 and 2 are 0."""
    df = d.float()
    finite = torch.isfinite(df)
    dz = torch.where(finite, df, torch.zeros_like(df))
    dd = torch.sum(dz * dz, dim=-1)
    if p is None:
        dp = pp = torch.zeros_like(dd)
    else:
        pf = p.float()
        dp = torch.sum(dz * pf, dim=-1)
        pp = torch.sum(pf * pf).expand(d.shape[0])
    nf = torch.sum(~finite, dim=-1).float()
    return torch.stack([dp, dd, pp, nf], dim=-1)


def epilogue_ref(d: torch.Tensor, p: torch.Tensor, coef, scale
                 ) -> torch.Tensor:
    """One client's epilogue: scale * (d - coef * p) in f32, cast to d's
    dtype; coef and scale one-element tensors (or floats)."""
    c = torch.as_tensor(coef, dtype=torch.float32).reshape(())
    s = torch.as_tensor(scale, dtype=torch.float32).reshape(())
    return (s * (d.float() - c * p.float())).to(d.dtype)


def project_and_scale_flat_ref(d: torch.Tensor, p: torch.Tensor,
                               lam: float, eps: float = 1e-12
                               ) -> torch.Tensor:
    """FedDPC's whole per-client modification of one flat delta (N,),
    with an explicit residual: scale·(d − coef·p), scale = lam +
    ||d|| / ||resid||."""
    df, pf = d.float(), p.float()
    dp = torch.dot(df, pf)
    pp = torch.dot(pf, pf)
    coef = torch.where(pp > eps, dp / torch.clamp(pp, min=eps),
                       torch.zeros_like(dp))
    resid = df - coef * pf
    scale = lam + torch.linalg.norm(df) / torch.clamp(
        torch.linalg.norm(resid), min=eps)
    return (scale * resid).to(d.dtype)


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


def buffer_fold_ref(d: torch.Tensor, p: torch.Tensor, w: torch.Tensor,
                    coefs: torch.Tensor, scales: torch.Tensor,
                    wgts: torch.Tensor, eta_g: float):
    """The buffered-async fold: the staleness discount multiplies the
    adaptive scale (the geometry, coef, stays raw), then the math is the
    batched epilogue — the reference trainer's order (scales * wgts,
    then a mean over the B arrivals)."""
    return batched_epilogue_ref(d, p, w, coefs,
                                scales.float() * wgts.float(), eta_g)


def dequant_ref(q: torch.Tensor, qscale: torch.Tensor, qzero: torch.Tensor,
                leaf_offsets: torch.Tensor) -> torch.Tensor:
    """The codec's dequant on the flat payload: column c of leaf l of row
    j is q[j, c] * qscale[j, l] + qzero[j, l], in f32 (a multiply, then
    an add: two roundings)."""
    counts = (leaf_offsets[1:] - leaf_offsets[:-1]).to(q.device)
    n = q.shape[-1]
    s = torch.repeat_interleave(qscale.float(), counts, dim=-1,
                                output_size=n)
    z = torch.repeat_interleave(qzero.float(), counts, dim=-1,
                                output_size=n)
    return q.float() * s + z


def dequant_batched_epilogue_ref(q, qscale, qzero, leaf_offsets, p, w,
                                 coefs, scales, eta_g):
    """Dequantize the (K, N) payload, then the batched epilogue."""
    return batched_epilogue_ref(dequant_ref(q, qscale, qzero, leaf_offsets),
                                p, w, coefs, scales, eta_g)


def dequant_buffer_fold_ref(q, qscale, qzero, leaf_offsets, p, w, coefs,
                            scales, wgts, eta_g):
    """Dequantize the (B, N) arrival buffer, then the buffered fold."""
    return buffer_fold_ref(dequant_ref(q, qscale, qzero, leaf_offsets),
                           p, w, coefs, scales, wgts, eta_g)
