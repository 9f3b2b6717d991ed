"""Plain PyTorch versions of the flash-attention kernel.

``attention_ref`` (counterpart of repro/kernels/flash_attention/ref.py,
line for line): full-matrix softmax attention with the kernel's masking
— causal, valid and sliding window on explicit positions — and its
fully-masked-row rule (output 0). The wrapper runs it on CPU tensors.

``attention_split_ref``: the same function computed as the kernel's
split decode computes it — per chunk of keys a partial (m, l, acc) in
f32, then the partials merged in chunk order. Nothing on the serving path
calls it; the tests hold it against the reference.

``bf16_steps``: how far a bf16 output is from the plain version's, in
bf16 steps at each output row's own scale — the kernel's bf16 gate beside
the reference's tolerance."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, q_pos, k_pos, window, soft_cap):
    """f32 scores (B, KV, G, Sq, Sk) with masked entries at NEG_INF, and
    the mask (B, 1, 1, Sq, Sk)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qf = q.reshape(b, sq, kv, h // kv, d).float() / math.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    ok = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window and window > 0:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    ok = ok[:, None, None, :, :]
    return torch.where(ok, s, NEG_INF), ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                  window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D), q_pos (B, Sq), k_pos (B, Sk)
    int -> (B, Sq, H, D) in q's dtype. Query head h reads KV head h // G,
    G = H / KV. A key counts when k_pos <= q_pos, k_pos >= 0 and (window
    = 0 or q_pos - k_pos < window); a row with no such key gives 0."""
    b, sq, h, d = q.shape
    s, ok = _scores(q, k, q_pos, k_pos, window, soft_cap)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(ok, p, 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        window: int = 0, soft_cap: float = 0.0,
                        chunk: int = 64) -> torch.Tensor:
    """``attention_ref``'s function, split over the keys: chunk i (keys i *
    chunk ...) gives m_i (its row max, NEG_INF when no key of it is
    visible), l_i = sum of exp(s - m_i) over its visible keys and acc_i
    the same weights times v; then M = max_i m_i, w_i = exp(m_i - M),
    l = sum_i w_i l_i and o = sum_i w_i acc_i / max(l, 1e-30), summed in
    chunk order. A dark chunk has weight 0 against a live one; a row
    with no visible key gives exactly 0."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n = -(-sk // chunk)
    s, ok = _scores(q, k, q_pos, k_pos, window, soft_cap)
    pad = n * chunk - sk
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    ok = torch.nn.functional.pad(ok, (0, pad), value=False)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = s.reshape(*s.shape[:-1], n, chunk)
    ok = ok.reshape(*ok.shape[:-1], n, chunk)
    m_i = s.amax(dim=-1)                                    # (b,kv,g,sq,n)
    p = torch.where(ok, torch.exp(s - m_i[..., None]), 0.0)
    l_i = p.sum(dim=-1)
    acc_i = torch.einsum("bkgqnc,bnckd->bkgqnd", p,
                         vf.reshape(b, n, chunk, kv, d))
    m = m_i.amax(dim=-1)
    l = torch.zeros_like(m)
    o = torch.zeros_like(acc_i[..., 0, :])
    for i in range(n):                                      # chunk order
        w = torch.exp(m_i[..., i] - m)
        l = l + w * l_i[..., i]
        o = o + w[..., None] * acc_i[..., i, :]
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over output rows (all but the last dim), of max |got -
    want| over the row in units of one bf16 step (2**-7 relative, the
    spacing of bf16 values) at the row's max |want|. Two bf16 roundings
    of f32 values that differ in their last bits are at most 1 apart; a
    row of zeros in ``want`` counts any difference as inf."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    step = torch.exp2(torch.floor(torch.log2(
        want.float().abs().amax(dim=-1))) - 7)
    return float(torch.where(err == 0, 0.0, err / step).max())
