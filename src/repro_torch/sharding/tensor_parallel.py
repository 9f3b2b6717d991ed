"""Tensor-parallel (Megatron) local training over the model axis: the
port's hand-written counterpart of the partitioning GSPMD derives in the
reference when it trains a model-parallel replica whose weights are
Megatron-sharded over ``model`` (repro/core/round.py's cross-silo round,
repro/launch/dryrun.py's train shapes).

A ``TPContext`` is the model group of one client slice: its process
group, this rank's place in it and its size. The Megatron operators are
``torch.autograd.Function``s over ``torch.distributed``:

  copy-to-region      identity forward, all-reduce (sum) backward — the
                      input of a column-parallel layer;
  reduce-from-region  all-reduce (sum) forward, identity backward — the
                      output of a row-parallel layer;
  all-reduce max      forward only (no gradient), for the vocab-parallel
                      cross entropy's shift;
  all-to-all          equal chunks of the leading dim exchanged, and the
                      gradient exchanged back — the expert-parallel MoE's
                      token exchange over the data group
                      (models/moe_ep.py; a ``TPContext`` of that group);
  all-gather          forward only, serving's: the vocab-parallel head's
                      logit slices, and the data ranks' rows of an
                      expert-parallel step's logits (launch/steps.py).

Each but the all-to-all has a ``vmap`` rule that issues its collective
ONCE on the whole batched tensor, so under the cohort's
``vmap(grad_and_value(...))`` (core/client.py) K clients cost one
collective, not K. Every collective
works on a fresh tensor (a clone the collective then writes), so no
input of a transform is written in place.

The vocab-parallel pieces (``embed_lookup``, ``cross_entropy``): a rank
holding rows [v0, v0 + V_m) of the embedding masks the ids outside them,
looks the rest up and sums over the group; the logits stay split over
the vocab, and the cross entropy takes its max and its sum of
exponentials over the group (two all-reduces of (B, S) scalars, and one
for the gold logit) instead of all-gathering (B, S, V) logits: a rank
holds V/M of the logits and the loss moves B·S numbers, not B·S·V.

Serving runs the same operators under ``torch.inference_mode``: each
forward collective runs as in training, and nothing records a backward.
``kv_span`` is the arithmetic of which KV heads a rank's query heads read
(models/attention._tp_kv; the rank's KV cache, sharding/layout.py).

The model code (models/attention.py, layers.py, moe.py, moe_ep.py,
ssm.py, encdec.py, transformer.py) takes a ``tp`` context and reads from its weights'
shapes which blocks are split: the tree it runs on is
sharding/layout.TPView's view of the rank's shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclass
class TPContext:
    """The model group of a client slice. ``timer(name, x, op)`` runs a
    collective ``op`` on ``x`` and may time it (core/round._Collectives);
    by default it just runs it."""
    group: object
    rank: int
    size: int
    timer: Optional[Callable] = field(default=None, repr=False)

    @classmethod
    def of(cls, group) -> "TPContext":
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def _collective(self, name: str, x: torch.Tensor, op) -> torch.Tensor:
        out = x.detach().clone(memory_format=torch.contiguous_format)
        self._timed(name, out, lambda: dist.all_reduce(out, op=op,
                                                        group=self.group))
        return out

    def _timed(self, name: str, x: torch.Tensor, run) -> None:
        if self.timer is None:
            run()
        else:
            self.timer(name, x, run)

    def exchange(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The all-to-all of ``x``'s leading dim in ``size`` equal
        chunks: chunk j goes to rank j, and chunk j of the result came
        from rank j. Gloo moves host memory only, so under gloo a CUDA
        tensor travels through a host copy."""
        x = x.detach().contiguous()
        host = x.is_cuda and dist.get_backend(self.group) == "gloo"
        src = x.cpu() if host else x
        out = torch.empty_like(src)
        self._timed(name, x, lambda: dist.all_to_all_single(
            out, src, group=self.group))
        return out.to(x.device) if host else out

    def all_gather(self, name: str, x: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` (one shape on every rank) concatenated along
        ``dim`` in rank order; under gloo a CUDA tensor travels through
        a host copy, as in ``exchange``."""
        x = x.detach().contiguous()
        host = x.is_cuda and dist.get_backend(self.group) == "gloo"
        src = x.cpu() if host else x
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self._timed(name, x, lambda: dist.all_gather(parts, src,
                                                     group=self.group))
        out = torch.cat(parts, dim)
        return out.to(x.device) if host else out


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(x, tp, name):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp, ctx.name = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromRegion.apply(g, ctx.tp, ctx.name), None, None

    @staticmethod
    def vmap(info, in_dims, x, tp, name):
        return _CopyToRegion.apply(x, tp, name), in_dims[0]


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(x, tp, name):
        return tp._collective(name, x, dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, tp, name):
        return _ReduceFromRegion.apply(x, tp, name), in_dims[0]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, tp, name):
        return tp.exchange(name, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp, ctx.name = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # equal chunks: the exchange is its own transpose
        return _AllToAll.apply(g, ctx.tp, ctx.name), None, None


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(x, tp):
        return tp._collective("tp_all_reduce", x, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        return _AllReduceMax.apply(x, tp), in_dims[0]


def copy_to_region(x: torch.Tensor, tp: Optional[TPContext],
                   name: str = "tp_all_reduce") -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    return x if tp is None else _CopyToRegion.apply(x, tp, name)


def reduce_from_region(x: torch.Tensor, tp: Optional[TPContext],
                       name: str = "tp_all_reduce") -> torch.Tensor:
    """The sum over the model group; the gradient passed as it is."""
    return x if tp is None else _ReduceFromRegion.apply(x, tp, name)


def all_to_all(x: torch.Tensor, tp: Optional[TPContext],
               name: str = "ep_all_to_all") -> torch.Tensor:
    """The all-to-all of ``x``'s leading dim over the group
    (``TPContext.exchange``); the gradient goes back the same way. An
    integer tensor carries no gradient. (Not under ``vmap``: the
    expert-parallel step that uses it trains one model, not a cohort.)"""
    if tp is None:
        return x
    if not x.is_floating_point():
        return tp.exchange(name, x)
    return _AllToAll.apply(x, tp, name)


def gather_from_region(x: torch.Tensor, tp: Optional[TPContext],
                       dim: int = -1,
                       name: str = "tp_all_gather") -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` concatenated in rank order
    (an all-gather; forward only: serving's logits)."""
    return x if tp is None else tp.all_gather(name, x, dim)


def attention_whole(cfg, model: int) -> bool:
    """Whether ``model`` ranks (> 1) run ``cfg``'s GQA attention whole:
    M does not divide the query heads, so every rank computes every head
    (sharding/layout.tp_classes classes its leaves WHOLE, and
    models/attention.tp_of runs it without ``tp``; GSPMD would split the
    heads mid-way)."""
    return (model > 1 and cfg.attention == "gqa" and bool(cfg.num_heads)
            and cfg.num_heads % model != 0)


def kv_span(num_heads: int, num_kv_heads: int, rank: int, heads: int):
    """(lo, hi, sel) of the query heads [rank·heads, (rank+1)·heads): the
    KV heads [lo, hi) they read, and ``sel`` None when each of those is
    read by heads / (hi − lo) consecutive query heads (grouped attention
    over hi − lo heads), else for each query head the index in [0, hi −
    lo) of its KV head (one KV head a query head)."""
    group = num_heads // num_kv_heads
    q0 = rank * heads
    lo, hi = q0 // group, (q0 + heads - 1) // group + 1
    sel = [(q0 + j) // group - lo for j in range(heads)]
    per = heads // (hi - lo)
    if per * (hi - lo) == heads and all(s == j // per
                                        for j, s in enumerate(sel)):
        sel = None
    return lo, hi, sel


def grad_on_first(x: torch.Tensor, tp: Optional[TPContext]
                  ) -> torch.Tensor:
    """``x`` with its gradient kept on model rank 0 alone: a term every
    rank computes alike (the MoE aux loss) whose inputs' gradients are
    summed over the group enters it once."""
    return x if tp is None or tp.rank == 0 else x.detach()


def all_reduce_max(x: torch.Tensor, tp: Optional[TPContext]
                   ) -> torch.Tensor:
    """The elementwise max over the model group (no gradient)."""
    return x.detach() if tp is None else _AllReduceMax.apply(x.detach(), tp)


# ---------------- the vocab-parallel embedding and loss ----------------

def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 tp: Optional[TPContext], vocab: int) -> torch.Tensor:
    """``table[tokens]`` of the whole (V, D) embedding, from this rank's
    rows [rank·V_m, (rank+1)·V_m) when the table is split on V (a
    vocab-parallel lookup: out-of-range ids give 0 here, and the sum
    over the group gives each id its row, exactly); a whole table is
    looked up as it is."""
    if tp is None or table.shape[-2] == vocab:
        return table[tokens]
    rows = table.shape[-2]
    v0 = tp.rank * rows
    local = tokens.long() - v0
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_region(x, tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  tp: Optional[TPContext], vocab: int) -> torch.Tensor:
    """Per position, logsumexp(logits) − logits[label] in f32 (labels
    < 0 give 0). ``logits`` (..., V) whole, or (..., V_m) this rank's
    vocab slice: then the shift, the sum of exponentials and the gold
    logit are reduced over the group."""
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    if tp is None or logits.shape[-1] == vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        return torch.where(valid, logz - gold, 0.0)
    cols = logits.shape[-1]
    v0 = tp.rank * cols
    shift = all_reduce_max(logits.amax(dim=-1), tp)
    sumexp = reduce_from_region(
        torch.exp(logits - shift[..., None]).sum(dim=-1), tp)
    local = safe - v0
    inside = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1,
                        torch.where(inside, local, 0)[..., None])[..., 0]
    gold = reduce_from_region(torch.where(inside, gold, 0.0), tp)
    return torch.where(valid, shift + torch.log(sumexp) - gold, 0.0)


def trains_tensor_parallel(loss_fn) -> bool:
    """Whether a task's loss trains tensor-parallel on the model axis: a
    models/transformer.LMLoss (its ``tensor_parallel``: every decoder
    family has a Megatron form). Any other loss — the vision models' —
    keeps the full-width row split (core/round.RankShard)."""
    return bool(getattr(loss_fn, "tensor_parallel", False))
