"""Mixture-of-Experts layer (counterpart of repro/models/moe.py): a top-k
router and capacity-slotted gather/scatter dispatch.

Tokens are routed in G groups of T_g tokens (``groups``; the reference
sets G to the mesh's token shards). Each (group, expert) has C slots,
C = ceil(T_g * k / E * cf) floored at MIN_CAPACITY and rounded up to a
multiple of 8 (of 128 from 128 on). An assignment's slot is its rank among the group's assignments
to its expert, by a STABLE sort on the expert id (token order within an
expert); assignments ranked past C are dropped into a dummy slot E·C
that is sliced off. Dispatch is a gather of the slots' tokens (the dummy
token T reads a zero row), the experts' SwiGLU products are batched
matrix products over (G, E, C, D), and combine is a scatter-add back to
token order (``index_add``: on a CUDA tensor by atomics, so a token's k
contributions sum in no fixed order there). Shared experts (DeepSeek-V2,
Kimi-K2) run densely on every token.

The router runs in f32 whatever the model dtype. ``jax.lax.top_k``
takes the lower expert index on a tie; the port's top-k is a stable
descending sort, which does the same. The aux loss is the Switch
load-balance term, E * sum(mean prob * assignment share), averaged over
groups and scaled by ``router_aux_coef``.

**Tensor-parallel experts** (``tp``, a sharding/tensor_parallel.TPContext
of the model group; the tree sharding/layout.TPView's): each expert's
ffn dim is split over the group — ``gate``/``up`` (E, D, F/M), ``down``
(E, F/M, D), the reference's rules ``mlp/(gate|up)`` (EXPERT, None,
model) and ``mlp/down`` (EXPERT, model, None) — and the shared experts
are Megatron's MLP. Every rank routes every token from the same input,
exactly as one process does, so all ranks fill the same slots; the
input passes one copy-to-region (the router, the dispatch and the
shared experts read it: their gradients are partial and are summed);
the experts' outputs are partial over the group, are weighted by their
gates and combined, the shared experts' partial added, and ONE
reduce-from-region of the (B, S, D) output sums them (the reference's
deferred sum, models/moe_ep.py: T·D numbers cross the group, not
E·C·D). The router's gradient through the gates is partial too
(sharding/layout.tp_classes sums it: PARTIAL), and the aux loss keeps
its gradient on model rank 0 (``tensor_parallel.grad_on_first``), so it
counts once in those sums.

Every op is out of place and batches under ``torch.func.vmap``, so the
FL trainer's ``vmap(grad)`` over a cohort trains an MoE decoder, on one
device or tensor-parallel.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (fold_rng, init_linear, linear,
                                       normal, split_rng)
from repro_torch.sharding import tensor_parallel as tpm

MIN_CAPACITY = 4


def init_moe(rng, cfg, dtype):
    """``rng``: a torch.Generator, a jax_prng key or "meta" (layers.py).
    The router is f32; the experts' (E, D, F) / (E, F, D) stacks and the
    shared experts' linears are in ``dtype``."""
    d, dff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ks = split_rng(rng, 5)
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": init_linear(ks[0], d, e, torch.float32),
        "gate": normal(ks[1], (e, d, dff), mul=scale).to(dtype),
        "up": normal(ks[2], (e, d, dff), mul=scale).to(dtype),
        "down": normal(ks[3], (e, dff, d), div=math.sqrt(dff)).to(dtype),
    }
    if cfg.num_shared_experts:
        hid = cfg.num_shared_experts * dff
        p["shared"] = {
            "gate": init_linear(fold_rng(ks[4], 0), d, hid, dtype),
            "up": init_linear(fold_rng(ks[4], 1), d, hid, dtype),
            "down": init_linear(fold_rng(ks[4], 2), hid, d, dtype),
        }
    return p


def round_capacity(c: int) -> int:
    """``c`` slots floored at MIN_CAPACITY and rounded up to a multiple
    of 8 (of 128 from 128 on)."""
    c = max(c, MIN_CAPACITY)
    mult = 128 if c >= 128 else 8
    return ((c + mult - 1) // mult) * mult


def capacity_per_group(cfg, tokens_per_group: int) -> int:
    return round_capacity(int(math.ceil(
        tokens_per_group * cfg.top_k / cfg.num_experts
        * cfg.capacity_factor)))


def _counts(idx: torch.Tensor, e: int, dtype) -> torch.Tensor:
    """(G, N) expert ids -> (G, E) assignment counts (a scatter-add, not
    a one-hot: O(N) memory)."""
    ones = torch.ones(idx.shape, dtype=dtype, device=idx.device)
    return torch.zeros(idx.shape[0], e, dtype=dtype,
                       device=idx.device).scatter_add(1, idx, ones)


def _route(cfg, logits: torch.Tensor):
    """logits (G, T, E) f32 -> gates (G, T, k) f32, idx (G, T, k) int64,
    aux (the unscaled load-balance term)."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    g, t, k = idx.shape
    e = cfg.num_experts
    me = probs.mean(dim=1)                                      # (G, E)
    ce = _counts(idx.reshape(g, t * k), e, torch.float32)
    ce = ce / torch.clamp(ce.sum(-1, keepdim=True), min=1.0)
    aux = (e * (me * ce).sum(-1)).mean()
    return gates, idx, aux


def _slot_tables(cfg, idx: torch.Tensor, gates: torch.Tensor, cap: int):
    """idx, gates (G, T, k) -> slot_token (G, E*C) int64 in [0, T] (T =
    empty) and slot_gate (G, E*C) f32. An assignment's position within
    its expert is its rank in a stable sort of the group's expert ids
    (index minus its expert's segment start)."""
    g, t, k = idx.shape
    e = cfg.num_experts
    tk = t * k
    flat_e = idx.reshape(g, tk).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)          # (G, Tk)
    counts = _counts(flat_e, e, torch.int64)
    starts = torch.cumsum(counts, dim=-1) - counts              # (G, E)
    sorted_e = torch.gather(flat_e, 1, order)
    rank_sorted = (torch.arange(tk, device=idx.device)[None]
                   - torch.gather(starts, 1, sorted_e))
    pos = torch.zeros_like(flat_e).scatter(1, order, rank_sorted)
    slot = torch.where(pos < cap, flat_e * cap + pos, e * cap)
    token = torch.arange(t, device=idx.device)[None, :, None].expand(
        g, t, k).reshape(g, tk)
    slot_token = torch.full((g, e * cap + 1), t, dtype=torch.int64,
                            device=idx.device).scatter(1, slot, token)
    slot_gate = torch.zeros((g, e * cap + 1), dtype=torch.float32,
                            device=idx.device).scatter(
        1, slot, gates.reshape(g, tk).float())
    return slot_token[:, :-1], slot_gate[:, :-1]


def moe_forward(cfg, p, x: torch.Tensor, *, groups: int = 1,
                shard_fn: Optional[Callable] = None, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), router_aux_coef * aux). ``groups``
    token groups (1 when B·S does not divide). ``shard_fn(tensor, role)``
    is called where the reference calls it (its placement hook): on the
    dispatched tokens (G, E, C, D), "dispatched"; the experts' hidden
    (G, E, C, F), "expert_hidden"; and the gated outputs (G, E·C, D),
    "combine"; its result is used in their place. ``tp``: this rank's
    part of the tensor-parallel layer (module docstring)."""
    b, s, d = x.shape
    shard_fn = shard_fn or (lambda z, role: z)
    t_total = b * s
    g = groups if t_total % groups == 0 else 1
    tg = t_total // g
    e = cfg.num_experts
    x = tpm.copy_to_region(x, tp)
    xt = x.reshape(g, tg, d)
    logits = linear(p["router"], xt.float())
    gates, idx, aux = _route(cfg, logits)
    cap = capacity_per_group(cfg, tg)
    slot_token, slot_gate = _slot_tables(cfg, idx, gates, cap)   # (G, E*C)

    # dispatch: a gather, the dummy token T reading a zero row
    xt_pad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1)
    xe = torch.gather(xt_pad, 1, slot_token[..., None].expand(g, e * cap, d))
    xe = shard_fn(xe.reshape(g, e, cap, d), "dispatched")
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["gate"])) \
        * torch.einsum("gecd,edf->gecf", xe, p["up"])
    h = shard_fn(h, "expert_hidden")
    ye = torch.einsum("gecf,efd->gecd", h, p["down"])           # (G,E,C,D)
    ye = ye * slot_gate.reshape(g, e, cap, 1).to(ye.dtype)
    ye = shard_fn(ye.reshape(g, e * cap, d), "combine")

    # combine: a scatter-add to token order (row T of each group is the
    # dummy's, dropped)
    rows = (slot_token + torch.arange(g, device=x.device)[:, None]
            * (tg + 1)).reshape(-1)
    out = ye.new_zeros(g * (tg + 1), d).index_add(
        0, rows, ye.reshape(g * e * cap, d))
    out = out.reshape(g, tg + 1, d)[:, :tg].reshape(b, s, d)

    out = shared_experts(cfg, p, x, out, tp)
    return out, tpm.grad_on_first(cfg.router_aux_coef * aux, tp)


def shared_experts(cfg, p, x: torch.Tensor, out: torch.Tensor, tp=None
                   ) -> torch.Tensor:
    """``out`` (B, S, D), the routed experts' output, plus the shared
    experts' on ``x``. With ``tp`` both are partial over the model group
    (the shared experts' down-projection row-parallel): the sum is
    reduced once here, and the down-projection's bias, if any, added
    after it."""
    b, s, d = x.shape
    if cfg.num_shared_experts:
        sh = p["shared"]
        xs = x.reshape(b * s, d)
        hs = F.silu(linear(sh["gate"], xs)) * linear(sh["up"], xs)
        if tp is None:
            return out + linear(sh["down"], hs).reshape(b, s, d)
        out = out + (hs @ sh["down"]["w"]).reshape(b, s, d)
    out = tpm.reduce_from_region(out, tp)
    if cfg.num_shared_experts and "b" in p["shared"]["down"]:
        out = out + p["shared"]["down"]["b"]
    return out
