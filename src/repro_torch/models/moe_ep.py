"""Expert-parallel MoE FFN with an explicit all-to-all dispatch
(counterpart of repro/models/moe_ep.py).

The reference writes it with ``shard_map`` over a (data, model) mesh;
the port runs one process per rank, so ``moe_forward_ep`` is one rank's
part, on its own tokens and its own experts, with the collectives over
the mesh's process groups (launch/mesh.make_debug_mesh):

  * tokens are split over the expert axis (``data``: this rank's rows of
    the batch); experts are split over the SAME axis: data rank s owns
    experts [s·E/S, (s+1)·E/S);
  * each rank routes its local tokens (f32 router, the stable top-k of
    models/moe.py) and packs a fixed-capacity send buffer bucketed by
    destination rank: an assignment's place in its bucket is its rank
    in a stable sort of the destinations, and the bucket holds
    ``_send_capacity`` slots (``MIN_CAPACITY``, multiples of 8 and of
    128 from 128 on); the rest drop;
  * one all-to-all over the expert axis exchanges the tokens, another
    their local expert ids (-1 for an empty slot);
  * each rank runs its E/S experts on its F/M ffn columns (the model
    axis) at ``per_e_cap`` slots an expert, the received slots sorted by
    expert with the empty ones sent to a sentinel segment;
  * a reverse all-to-all returns the experts' outputs, partial over the
    model axis, and the rank combines them with its gates in f32; then
    ONE sum over the model group finishes the row-parallel down
    projection (the reference defers its psum to after the combine:
    T·D numbers cross the group, not E·C·D);
  * ``aux`` is the mean of the ranks' load-balance terms over the
    expert axis; the shared experts run as in the tensor-parallel MoE
    (models/moe.py), their partial summed into the same reduction.

Gradients: the all-to-all's backward is the reverse all-to-all
(sharding/tensor_parallel.all_to_all), so an expert's gradient gathers
every rank's tokens. A rank's own terms are its share of the step's
loss: the aux mean is a reduce-from-region of aux/S over the expert
axis (the gradient of each rank's term 1/S of the mean's), and on the
model axis the input's copy-to-region, the router's summed gradient and
the aux loss on model rank 0 are models/moe.py's. With a mesh of one
rank (a 1 x 1 ``make_debug_mesh``, launch/mesh.LocalMesh) no collective
runs.

Capacity differs from models/moe.py's GShard dispatch by design: that
drops per (group, expert), this per (source, destination) bucket and
then per expert; the two agree when nothing drops (the reference holds
them equal at capacity_factor 8).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_group
from repro_torch.models.layers import linear
from repro_torch.models.moe import _route, round_capacity, shared_experts
from repro_torch.sharding import tensor_parallel as tpm


def _send_capacity(cfg, tokens_per_shard: int, num_shards: int) -> int:
    """Capacity of the (src shard -> dst shard) bucket."""
    return round_capacity(int(math.ceil(
        tokens_per_shard * cfg.top_k / num_shards * cfg.capacity_factor)))


def expert_axis_of(mesh, expert_axis=None, model_axis: str = "model"):
    """The expert axis: ``expert_axis``, or the mesh's one axis that is
    not ``model_axis`` (the reference spans every non-model axis; the
    port's meshes have one)."""
    if expert_axis is not None:
        return expert_axis
    axes = [a for a in mesh.mesh_dim_names if a != model_axis]
    if len(axes) != 1:
        raise NotImplementedError(
            f"an expert axis over {axes}: the port's (data, model) mesh "
            "has one axis besides the model axis")
    return axes[0]


def contexts(mesh, expert_axis=None, model_axis: str = "model"):
    """(ep, tp): sharding/tensor_parallel.TPContexts of this rank's
    groups over the expert and the model axis, None for an axis of one
    rank."""
    axis = expert_axis_of(mesh, expert_axis, model_axis)
    out = []
    for name in (axis, model_axis):
        group = axis_group(mesh, name)
        out.append(None if group is None else tpm.TPContext.of(group))
    return tuple(out)


def _bucket_ranks(key: torch.Tensor, buckets: int) -> torch.Tensor:
    """Each entry's rank among the entries of its bucket, in entry
    order (a stable sort on the bucket id)."""
    n = key.numel()
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=buckets)
    starts = torch.cumsum(counts, 0) - counts
    ranked = torch.arange(n, device=key.device) - starts[key[order]]
    return torch.zeros_like(key).scatter(0, order, ranked)


def moe_forward_ep(cfg, p, x: torch.Tensor, *, mesh, expert_axis=None,
                   model_axis: str = "model", ep=None, tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the expert-parallel MoE layer. ``x`` (B_l, S,
    D): its tokens; ``p``: the layer's tree with the rank's experts,
    ``gate``/``up`` (E/S, D, F/M) and ``down`` (E/S, F/M, D) (the
    reference's ``param_specs`` with ``expert_axis`` over the experts and
    ``model`` over their ffn dim: sharding/layout.ShardLayout.for_experts),
    the router whole and the shared experts Megatron-split over the model
    axis. ``ep``/``tp``: the axes' contexts (``contexts(mesh)`` when not
    given; their timers time the collectives). Returns (out (B_l, S, D),
    router_aux_coef · aux), aux the expert axis's mean."""
    if ep is None and tp is None:
        ep, tp = contexts(mesh, expert_axis, model_axis)
    b, s, d = x.shape
    n_shards = 1 if ep is None else ep.size
    e_total = cfg.num_experts
    if e_total % n_shards:
        raise ValueError(f"{e_total} experts over {n_shards} shards")
    e_local = e_total // n_shards
    if p["gate"].shape[0] != e_local:
        raise ValueError(f"rank holds {p['gate'].shape[0]} experts, the "
                         f"expert axis gives it {e_local}")
    tl = b * s
    cap = _send_capacity(cfg, tl, n_shards)
    dev = x.device

    x = tpm.copy_to_region(x, tp)
    xt = x.reshape(tl, d)
    logits = linear(p["router"], xt.float())                 # (T_l, E)
    gates, idx, aux = _route(cfg, logits[None])
    gates, idx = gates[0], idx[0]                            # (T_l, k)
    if ep is not None:
        aux = tpm.reduce_from_region(aux / n_shards, ep, "ep_all_reduce")

    flat_e = idx.reshape(-1)
    dest = torch.div(flat_e, e_local, rounding_mode="floor")
    rank = _bucket_ranks(dest, n_shards)
    keep = rank < cap
    slot = torch.where(keep, dest * cap + rank, n_shards * cap)
    token_of = torch.arange(tl, device=dev)[:, None].expand(
        tl, cfg.top_k).reshape(-1)
    rows = n_shards * cap
    send_tok = torch.full((rows + 1,), tl, dtype=torch.int64,
                          device=dev).scatter(0, slot, token_of)[:-1]
    send_exp = torch.zeros(rows + 1, dtype=torch.int64, device=dev
                           ).scatter(0, slot, flat_e % e_local)[:-1]
    send_gate = torch.zeros(rows + 1, dtype=torch.float32, device=dev
                            ).scatter(0, slot, gates.reshape(-1))[:-1]
    xt_pad = torch.cat([xt, xt.new_zeros(1, d)], 0)
    send_x = xt_pad[send_tok]                                # (S·C, D)

    # exchange: chunk j (C rows) to rank j; an empty slot's id is -1
    recv_x = tpm.all_to_all(send_x, ep)
    recv_exp = tpm.all_to_all(torch.where(send_tok < tl, send_exp, -1), ep)
    rvalid = recv_exp >= 0
    rexp = torch.clamp(recv_exp, min=0)

    # the local experts at per_e_cap slots each; the empty slots sort
    # into a sentinel segment e_local
    per_e_cap = round_capacity(rows // e_local)
    key2 = torch.where(rvalid, rexp, e_local)
    rank2 = _bucket_ranks(key2, e_local + 1)
    keep2 = (rank2 < per_e_cap) & rvalid
    dummy = e_local * per_e_cap
    slot2 = torch.where(keep2, rexp * per_e_cap + rank2, dummy)
    tbl = torch.full((dummy + 1,), rows, dtype=torch.int64, device=dev
                     ).scatter(0, slot2, torch.arange(rows, device=dev)
                               )[:-1]
    rx_pad = torch.cat([recv_x, recv_x.new_zeros(1, d)], 0)
    xe = rx_pad[tbl].reshape(e_local, per_e_cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["gate"])) \
        * torch.einsum("ecd,edf->ecf", xe, p["up"])
    # partial over the model axis: summed after the combine
    ye = torch.einsum("ecf,efd->ecd", h, p["down"]).to(x.dtype)

    ye_pad = torch.cat([ye.reshape(dummy, d), ye.new_zeros(1, d)], 0)
    back = torch.where(keep2[:, None], ye_pad[slot2], 0.0)
    ret = tpm.all_to_all(back, ep)

    # combine with the gates in f32, then the model axis's one sum
    weighted = ret.float() * send_gate[:, None]
    out = torch.zeros(tl + 1, d, dtype=torch.float32, device=dev
                      ).index_add(0, send_tok, weighted)[:-1]
    out = shared_experts(cfg, p, x, out.to(x.dtype).reshape(b, s, d), tp)
    return out, tpm.grad_on_first(cfg.router_aux_coef * aux, tp)

