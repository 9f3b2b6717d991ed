"""Plain PyTorch version of the flash-attention kernel (counterpart of
repro/kernels/flash_attention/ref.py, line for line): full-matrix softmax
attention with the kernel's masking — causal, valid and sliding window
on explicit positions — and its fully-masked-row rule (output 0)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                  window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D), q_pos (B, Sq), k_pos (B, Sk)
    int -> (B, Sq, H, D) in q's dtype. Query head h reads KV head h // G,
    G = H / KV. A key counts when k_pos <= q_pos, k_pos >= 0 and (window
    = 0 or q_pos - k_pos < window); a row with no such key gives 0."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.reshape(b, sq, kv, g, d).float() / math.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    ok = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window and window > 0:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    ok = ok[:, None, None, :, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(ok, p, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
