"""Mamba-1 selective SSM block (counterpart of repro/models/ssm.py, the
Falcon-Mamba mixer).

Recurrence per channel c and state n:
    h_t = exp(dt_t * A[c,n]) * h_{t-1} + dt_t * B_t[n] * u_t[c]
    y_t = sum_n C_t[n] * h_t[c,n] + D[c] * u_t[c]

The reference's model runs prefill as an associative scan over (B, S,
d_in, N) tensors and decode as the one-step recurrence in jnp; its Pallas
kernel is never on that path. Here every scan — fresh prefill,
continuation from a carried state, one-token decode — goes through
``kernels/ssm_scan``: ``impl="auto"`` is ``ops.ssm_scan`` (the kernel for
CUDA tensors, its plain version for CPU tensors) and ``impl="reference"``
the plain version on any device. A continuation starts the recurrence
from the carried h where the reference adds ``cum_decay * h0`` after its
scan: the same value by linearity, up to rounding.

The scan call is the fused one: it is handed x_proj's raw dt rows times
W_dt, dt's bias and the gate's z, and forms dt = softplus(raw + bias) and
the output y * silu(z) itself, rounded as the eager ops round them (the
plain version runs those very ops) — one launch, and no eager softplus
chain or gate around it.

Parameters keep the reference's tree and names; ``a_log`` and ``d_skip``
are f32 whatever the model dtype, and dt is computed in f32 from the
(model-dtype) projection.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.models.layers import (init_linear, linear, normal,
                                       rng_device, split_rng)

IMPLS = ("auto", "reference")


def init_mamba(rng, cfg, dtype):
    """``rng``: a torch.Generator, a jax_prng key or "meta" (layers.py)."""
    d, d_in = cfg.d_model, cfg.ssm_d_inner
    st, dtr, cw = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    dev = rng_device(rng)
    ks = split_rng(rng, 6)
    a_init = torch.arange(1, st + 1, dtype=torch.float32,
                          device=dev)[None, :].repeat(d_in, 1)
    return {
        "in_proj": init_linear(ks[0], d, 2 * d_in, dtype),
        "conv_w": normal(ks[1], (cw, d_in), div=math.sqrt(cw)).to(dtype),
        "conv_b": torch.zeros(d_in, dtype=dtype, device=dev),
        "x_proj": init_linear(ks[2], d_in, dtr + 2 * st, dtype),
        "dt_proj": {"w": normal(ks[3], (dtr, d_in),
                                div=math.sqrt(dtr)).to(dtype),
                    "b": torch.full((d_in,), -4.6, dtype=dtype,
                                    device=dev)},     # softplus^-1(0.01)
        "a_log": torch.log(a_init),                   # f32, A = -exp(a_log)
        "d_skip": torch.ones(d_in, dtype=torch.float32, device=dev),
        "out_proj": init_linear(ks[4], d_in, d, dtype),
    }


def init_ssm_state(cfg, batch, dtype, device=None):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def _ssm_params(cfg, p, u):
    """u: (..., d_in) -> dt's raw value (..., d_in) f32 (x_proj's dt rows
    times W_dt; the scan adds the bias and takes softplus), B/C (..., st)
    f32."""
    st, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    proj = linear(p["x_proj"], u)
    dt = proj[..., :dtr].float() @ p["dt_proj"]["w"].float()
    b = proj[..., dtr:dtr + st].float()
    c = proj[..., dtr + st:].float()
    return dt, b, c


def _scan(cfg, p, u_c, z, h0, impl):
    """The selective scan of u_c (B, S, d_in) post-conv/silu from h0, with
    dt's bias and softplus and the gate by z folded in -> (y * silu(z) in
    u_c's dtype, h_final f32)."""
    a = -torch.exp(p["a_log"])
    dt, bmat, cmat = _ssm_params(cfg, p, u_c)
    scan = ssm_ops.ssm_scan if impl == "auto" else ssm_ref.ssm_scan_ref
    return scan(u_c, dt, bmat, cmat, a, p["d_skip"], h0,
                dt_bias=p["dt_proj"]["b"].float(), dt_softplus=True, z=z)


def mamba_forward(cfg, p, x, *, state: Optional[dict] = None,
                  impl: str = "auto") -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D). state None -> full-sequence scan (prefill; returns
    the state for continuation); state given with S > 1 -> a prefill
    continuation from it; state given with S == 1 -> one decode step."""
    if impl not in IMPLS:
        raise ValueError(f"mamba_forward: impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    b, s, _ = x.shape
    d_in, cw = cfg.ssm_d_inner, cfg.ssm_conv
    xz = linear(p["in_proj"], x)
    u, z = xz[..., :d_in], xz[..., d_in:]

    if state is None or s > 1:
        prev = (state["conv"] if state is not None
                else torch.zeros((b, cw - 1, d_in), dtype=u.dtype,
                                 device=u.device))
        u_ext = torch.cat([prev, u], dim=1)
        conv_in = u_ext[:, -(s + cw - 1):]
        u_c = F.silu(_conv_causal_from(p, conv_in, s, cw))
        out, h_last = _scan(cfg, p, u_c, z,
                            None if state is None else state["h"], impl)
        # a copy: a view would keep the whole (B, S + cw - 1, d_in) u_ext
        # alive in every layer's state (16 GiB at B 8, S 1024, f32)
        new_state = {"conv": u_ext[:, -(cw - 1):].to(u.dtype).clone(),
                     "h": h_last}
    else:
        # decode: one token, the kernel at S = 1 from the carried state
        conv_window = torch.cat([state["conv"], u], dim=1)    # (B, cw, d_in)
        u_c = F.silu(torch.einsum("bwd,wd->bd", conv_window, p["conv_w"])
                     + p["conv_b"])[:, None, :]
        out, h = _scan(cfg, p, u_c, z, state["h"], impl)
        new_state = {"conv": conv_window[:, 1:], "h": h}

    return linear(p["out_proj"], out), new_state


def _conv_causal_from(p, u_ext, s, window):
    """u_ext: (B, S + window - 1, d_in) already left-extended; the
    reference's Python sum of ``window`` products, then the bias."""
    out = sum(u_ext[:, i:i + s, :] * p["conv_w"][i] for i in range(window))
    return out + p["conv_b"]
