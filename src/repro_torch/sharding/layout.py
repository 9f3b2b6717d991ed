"""Where each model rank's shard of the flat parameter vector lives: the
port's hand-written counterpart of the layout GSPMD derives in the
reference from ``sharding/rules.cohort_param_specs``.

The port keeps a parameter tree as one flat (N,) vector in the
reference's leaf order, each leaf row-major in the reference's shape
(``bridge.FlatLayout``). On a two-axis (clients, model) mesh of M model
ranks, a leaf whose spec puts ``model`` on dim d is cut into M equal
slices along d; model rank m holds ``leaf[..., slice_m on d, ...]``,
row-major. A leaf the spec replicates is owned by model rank 0 alone,
so every element is in exactly one shard: a dot or norm over the
shards, summed over the model ranks, counts each element once.

Model rank m's shard is one flat vector of N_m elements, its leaves in
the layout's order, the leaves it holds nothing of left out (so
``offsets(m)`` is strictly increasing, as the kernels' leaf-offset
checks want). A held leaf is a strided slice of the full vector: the
leaf viewed as (pre, D, post), the shard takes ``[:, lo:lo + per, :]``
(a replicated leaf: pre = post = 1, the whole leaf). Scatter, gather
and unpad copy those slices; nothing holds a map of N_m or N positions.

On the tensor-parallel route a Megatron-split leaf's shard IS the rank's
tensor-parallel weight: ``tp_classes`` sorts the leaves, ``TPView`` shows
the shard to the model as its tree (sharding/tensor_parallel.py).

**The expert-parallel layout** (``ShardLayout.for_experts``, the
reference's ``param_specs`` under ``ShardingPolicy(expert_axis="data")``
on a (data, model) mesh, models/moe_ep.py): the MoE expert stacks are cut
on E over ``data`` as well as on their ffn dim over ``model``, every
other leaf over ``model`` alone. Rank r = d·M + m holds its slice of each
leaf; a leaf not cut over ``data`` is held by every data row alike (its
copies step together: their gradients are summed over the data group).
A leaf cut on two dims is one strided block for each index of the dims
before the first cut (the stacked layers' groups), the blocks together
the rank's local tensor, row-major.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.bridge import FlatLayout, tree_map
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.rules import (ShardingPolicy, cohort_leaf_specs,
                                        leaf_specs, mesh_axes, path_str)


class Block(NamedTuple):
    """A strided slice of the full vector: elements
    ``full[start:start + pre*D*post]`` viewed as (pre, D, post), rows
    ``lo:lo + per`` of the middle dim, at ``at`` in the shard."""
    leaf: int
    start: int
    pre: int
    D: int
    post: int
    lo: int
    per: int
    at: int

    @property
    def size(self) -> int:
        return self.pre * self.per * self.post


def _axis_dim(spec, axis):
    """The tensor dim ``spec`` puts ``axis`` on, or None."""
    return next((d for d, ax in enumerate(spec)
                 if ax == axis or (isinstance(ax, tuple) and axis in ax)),
                None)


def _cut(leaf: int, start: int, shape, cuts) -> List[Block]:
    """The blocks of a leaf at ``start`` cut on the dims of ``cuts``
    ({dim: (lo, per)}, at most two), row-major: none cut, the whole leaf;
    one, one block; two dims i < j, one block per index of the dims
    before i, its rows the ``per_i`` slices of dim i with the dims
    between, its columns the slice of dim j."""
    numel = int(np.prod(shape, dtype=np.int64))
    if not cuts:
        return [Block(leaf, start, 1, numel, 1, 0, numel, 0)]
    dims = sorted(cuts)
    prod = lambda a, b: int(np.prod(shape[a:b], dtype=np.int64))
    if len(dims) == 1:
        (i,) = dims
        return [Block(leaf, start, prod(0, i), shape[i],
                      prod(i + 1, len(shape)), *cuts[i], 0)]
    i, j = dims
    (lo_i, per_i), (lo_j, per_j) = cuts[i], cuts[j]
    inner = prod(i + 1, len(shape))
    return [Block(leaf, start + o * shape[i] * inner + lo_i * inner,
                  per_i * prod(i + 1, j), shape[j], prod(j + 1, len(shape)),
                  lo_j, per_j, 0)
            for o in range(prod(0, i))]


class ShardLayout:
    """The shards of a FlatLayout under per-leaf specs (see the module
    docstring): M model shards, or with ``data`` > 1 the D·M shards of a
    (data, model) mesh, rank d·M + m. ``specs`` holds one spec per leaf,
    in the layout's order."""

    def __init__(self, layout: FlatLayout, specs: Sequence, model: int,
                 model_axis: str = "model", data: int = 1,
                 data_axis: str = None):
        if len(specs) != len(layout.shapes):
            raise ValueError(f"{len(specs)} specs for {len(layout.shapes)} "
                             "leaves")
        self.layout = layout
        self.model = int(model)
        self.data = int(data)
        self.ranks = self.model * self.data
        self.specs = tuple(specs)
        starts = np.concatenate([[0], np.cumsum(layout.numels)])
        self._blocks: List[List[Block]] = [[] for _ in range(self.ranks)]
        self._local: List[Dict[int, tuple]] = [{} for _ in range(self.ranks)]
        held = 0
        for i, (shape, spec) in enumerate(zip(layout.shapes, specs)):
            shape = tuple(int(d) for d in shape)
            mdim, ddim = (_axis_dim(spec, model_axis),
                          _axis_dim(spec, data_axis) if data_axis else None)
            held += int(np.prod(shape, dtype=np.int64)) * (
                1 if ddim is not None else self.data)
            for r in range(self.ranks):
                d, m = divmod(r, self.model)
                if mdim is None and m:
                    continue            # model rank 0 owns it
                cuts = {}
                for dim, c, n in ((mdim, m, self.model),
                                  (ddim, d, self.data)):
                    if dim is not None:
                        per = shape[dim] // n
                        cuts[dim] = (c * per, per)
                local = tuple(cuts[k][1] if k in cuts else n
                              for k, n in enumerate(shape))
                if not int(np.prod(local, dtype=np.int64)):
                    continue
                blocks = self._blocks[r]
                at = blocks[-1].at + blocks[-1].size if blocks else 0
                for b in _cut(i, int(starts[i]), shape, cuts):
                    blocks.append(b._replace(at=at))
                    at += b.size
                self._local[r][i] = local
        self.sizes = tuple(sum(b.size for b in bl) for bl in self._blocks)
        if sum(self.sizes) != held:
            raise AssertionError("the shards do not cover the layout")
        self._runs = [self._merge(bl) for bl in self._blocks]

    @staticmethod
    def _merge(blocks: Sequence[Block]) -> List[Block]:
        """The copies a move makes: each block, neighbours that are one
        contiguous range of the full vector (pre = 1) merged into one."""
        runs: List[Block] = []
        for b in blocks:
            if b.pre == 1:
                b = Block(b.leaf, b.start + b.lo * b.post, 1, b.size, 1, 0,
                          b.size, b.at)
                last = runs[-1] if runs else None
                if (last is not None and last.pre == 1
                        and last.start + last.size == b.start):
                    runs[-1] = last._replace(D=last.D + b.D,
                                             per=last.per + b.per)
                    continue
            runs.append(b)
        return runs

    @classmethod
    def from_mesh(cls, layout: FlatLayout, mesh, client_axis: str = "clients",
                  model_axis: str = "model") -> "ShardLayout":
        """The layout's shards under ``cohort_param_specs`` on ``mesh``
        (a port DeviceMesh or a shape-only stand-in)."""
        sizes = mesh_axes(mesh)
        return cls.from_sizes(layout, sizes, client_axis, model_axis)

    @classmethod
    def from_sizes(cls, layout: FlatLayout, axis_sizes: Dict[str, int],
                   client_axis: str = "clients",
                   model_axis: str = "model") -> "ShardLayout":
        pairs = [(path_str(p), s) for p, s in zip(layout.paths,
                                                  layout.shapes)]
        specs = cohort_leaf_specs(pairs, axis_sizes, client_axis,
                                  model_axis)
        return cls(layout, specs, axis_sizes.get(model_axis, 1), model_axis)

    @classmethod
    def for_experts(cls, layout: FlatLayout, data: int,
                    model: int) -> "ShardLayout":
        """The D·M shards of the expert-parallel train step on a
        (data, model) mesh: the reference's ``param_specs`` under
        ``ShardingPolicy(expert_axis="data")`` (module docstring)."""
        pairs = [(path_str(p), s) for p, s in zip(layout.paths,
                                                  layout.shapes)]
        pol = ShardingPolicy(batch_axes=("data",), expert_axis="data")
        specs = leaf_specs(pairs, {"data": data, "model": model}, pol)
        return cls(layout, specs, model, "model", data, "data")

    # ---- per shard ----

    @property
    def max_size(self) -> int:
        return max(self.sizes)

    def held(self, r: int) -> List[tuple]:
        """[(leaf, local shape)] of the leaves shard r holds, in order:
        the leaf's blocks, concatenated, are its local tensor row-major
        (its cut dims cut D- or M-fold)."""
        return list(self._local[r].items())

    # the three below read a model-axis layout: one block a held leaf

    def leaf_ids(self, m: int) -> np.ndarray:
        """The layout's leaf numbers of the leaves shard m holds."""
        return np.asarray([b.leaf for b in self._blocks[m]], np.int64)

    def offsets(self, m: int) -> torch.Tensor:
        """(L_m+1,) CPU int64: where each held leaf starts in shard m,
        then N_m (the codec's and the dequant folds' leaf_offsets)."""
        return torch.tensor([b.at for b in self._blocks[m]]
                            + [self.sizes[m]], dtype=torch.int64)

    def leaf_blocks(self, m: int) -> torch.Tensor:
        """(L_m, 4) CPU int64, per held leaf: its whole element count,
        then (inner, stride, base) such that the shard's p-th element of
        the leaf is element ``(p // inner) * stride + base + p % inner``
        of the whole leaf, row-major (int8_sr's counter)."""
        return torch.tensor([[b.pre * b.D * b.post, b.per * b.post,
                              b.D * b.post, b.lo * b.post]
                             for b in self._blocks[m]], dtype=torch.int64)

    # ---- moving between the full vector and the shards ----

    @staticmethod
    def _views(full: torch.Tensor, shard: torch.Tensor, b: Block):
        """The block's (..., pre, per, post) views of a (..., N) and a
        (..., N_m) tensor."""
        src = full[..., b.start:b.start + b.pre * b.D * b.post].unflatten(
            -1, (b.pre, b.D, b.post))[..., b.lo:b.lo + b.per, :]
        dst = shard[..., b.at:b.at + b.size].unflatten(
            -1, (b.pre, b.per, b.post))
        return src, dst

    def scatter(self, full: torch.Tensor, m: int,
                out: torch.Tensor = None) -> torch.Tensor:
        """Shard m of a (..., N) tensor, into ``out`` (..., N_m) or a new
        tensor."""
        if out is None:
            out = full.new_empty(tuple(full.shape[:-1]) + (self.sizes[m],))
        for b in self._runs[m]:
            src, dst = self._views(full, out, b)
            dst.copy_(src)
        return out

    def _leaf_blocks(self, r: int, i: int) -> List[Block]:
        return [b for b in self._blocks[r] if b.leaf == i]

    def leaf_piece(self, r: int, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """Shard r's piece of leaf i (its blocks, row-major: the rank's
        local tensor, flat) from the whole leaf alone — a leaf at a time,
        where the whole (N,) vector would not fit; empty where shard r
        holds none of it."""
        flat = leaf.reshape(-1)
        base = int(self.layout.leaf_offsets[i])
        out = [flat[b.start - base:b.start - base + b.pre * b.D * b.post]
               .view(b.pre, b.D, b.post)[:, b.lo:b.lo + b.per].reshape(-1)
               for b in self._leaf_blocks(r, i)]
        return torch.cat(out) if out else flat[:0]

    def leaf_from_pieces(self, i: int, pieces: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
        """Leaf i whole (flat) from every shard's piece of it
        (``leaf_piece``'s, a piece no shorter than that)."""
        base = int(self.layout.leaf_offsets[i])
        out = pieces[0].new_empty(int(self.layout.numels[i]))
        for r, piece in enumerate(pieces):
            at = 0
            for b in self._leaf_blocks(r, i):
                dst = out[b.start - base:b.start - base
                          + b.pre * b.D * b.post].view(b.pre, b.D, b.post)
                dst[:, b.lo:b.lo + b.per].copy_(
                    piece[at:at + b.size].view(b.pre, b.per, b.post))
                at += b.size
        return out

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The (..., N) tensor from its M (..., N_m) shards (from all D·M
        of a (data, model) layout, whose data rows hold their common
        leaves alike)."""
        lead = tuple(shards[0].shape[:-1])
        full = shards[0].new_empty(lead + (self.layout.size,))
        for m, s in enumerate(shards):
            for b in self._runs[m]:
                dst, src = self._views(full, s, b)
                dst.copy_(src)
        return full

    def unpad(self, padded: torch.Tensor) -> torch.Tensor:
        """(..., M, max_size) shards padded to one width (an all-gather's
        output) -> the (..., N) tensor."""
        return self.gather([padded[..., m, :self.sizes[m]]
                            for m in range(self.ranks)])


# ---------------- the tensor-parallel view of a shard ----------------

VIEW, WHOLE, PARTIAL = "view", "whole", "partial"

# the leaves Megatron splits: regex over the "/"-joined path -> the
# split dim, counted from the end (the rules' convention), and whether
# the split must fall on attention-head boundaries
MEGATRON = (
    (r"(wq|wk|wv)/[wb]$", -1, True),         # column-parallel
    (r"wo/w$", -2, True),                    # row-parallel
    (r"mlp/(gate|up)$", -1, False),          # MoE experts (E, D, F)
    (r"mlp/down$", -2, False),               # MoE experts (E, F, D)
    (r"(gate|up)/[wb]$", -1, False),         # column-parallel
    (r"down/w$", -2, False),                 # row-parallel
    (r"(^|/)embed$", -2, False),             # vocab-parallel
    (r"lm_head/w$", -1, False),
)
_KV = r"(wk|wv)/[wb]$"
# the MoE router: every rank routes from the whole (D, E) weight, and its
# gradient through the gates is partial (the experts' outputs are, before
# the combine's sum over the group), so it is summed
_ROUTER = r"router/[wb]$"
# the leaves the route needs split: attention, MLP and experts in parallel
_REQUIRED = (r"wq/w$", r"wo/w$", r"(gate|up)/w$", r"down/w$",
             r"mlp/(gate|up)$", r"mlp/down$")


def megatron_dim(path: str):
    """(split dim from the end, head-aligned) of a Megatron-split leaf's
    path, or None for a leaf Megatron replicates."""
    for pat, dim, heads in MEGATRON:
        if re.search(pat, path):
            return dim, heads
    return None


def tp_classes(shards: ShardLayout, head_dim: int) -> List[str]:
    """Each leaf's class on the tensor-parallel route over ``shards``:
    VIEW where the layout splits the leaf on its Megatron dim (on head
    boundaries for the attention projections): the rank's shard is its
    tensor-parallel weight, viewed in place. PARTIAL for ``wk``/``wv``
    and their biases otherwise (M does not divide the KV heads): each
    rank computes the KV heads its query heads read from the whole leaf,
    so its gradient is partial and is summed over the group; and for the
    MoE router, whose gradient through the gates is partial (the
    experts' outputs are summed over the group after the combine). WHOLE
    for every other leaf — norms, ``wo/b``, ``down/b``, and ``embed`` or
    ``lm_head`` when M does not divide the vocabulary — which every rank
    computes alike, so each keeps its slice of the same gradient. Raises
    when a query, output, MLP or expert projection is not split so: the
    route needs M to divide the query heads, the MLP width and the
    experts' ffn dim."""
    layout = shards.layout
    out = []
    for i, (shape, spec) in enumerate(zip(layout.shapes, shards.specs)):
        path = path_str(layout.paths[i])
        md = megatron_dim(path)
        cls = PARTIAL if re.search(_ROUTER, path) else WHOLE
        if md is not None:
            dim = md[0] % len(shape)
            split = shards.model > 1 and spec[dim] is not None
            if split and md[1]:
                split = (shape[dim] // shards.model) % head_dim == 0
            if split:
                cls = VIEW
            elif re.search(_KV, path):
                cls = PARTIAL
            elif any(re.search(p, path) for p in _REQUIRED):
                raise ValueError(
                    f"tensor parallelism over {shards.model} model ranks: "
                    f"{path} {tuple(shape)} does not split on its Megatron "
                    f"dim (spec {spec}); the model axis must divide the "
                    "query heads, the MLP width and the experts' ffn dim")
        out.append(cls)
    return out


class TPView:
    """Model rank ``m``'s shard as the tree the model runs on
    (sharding/tensor_parallel.py). ``unflatten(w)`` of the rank's (N_m,)
    vector — a row of the cohort's (K, N_m) stack under vmap — gives the
    layout's tree with every VIEW leaf the rank's slice in its local
    shape (the Megatron dim cut M-fold) and every other leaf whole.
    ``rank`` is the shard's place in a (data, model) layout
    (ShardLayout.for_experts: d·M + m; ``m`` by default): there an
    expert stack is also cut on E, and a layout of one model rank is
    viewed as it is, every leaf in its local shape, nothing gathered.

    The shard is cut into its held leaves by one ``torch.split``
    (autograd then pays one concatenation). The WHOLE and PARTIAL leaves
    are gathered in one reduce-from-region over the model group
    ("tp_leaf_gather"): each rank's pieces placed in a zero vector of
    the leaves' whole size, summed (exact: one rank holds each element).
    Backward, a WHOLE leaf's gradient is the same on every rank and each
    keeps its slice; the PARTIAL leaves pass a copy-to-region, so their
    gradient is summed over the group before the rank keeps its slice.
    A leaf the layout gives to model rank 0 alone is WHOLE: every rank
    computes with it, rank 0 keeps its gradient."""

    def __init__(self, shards: ShardLayout, m: int, head_dim: int, tp,
                 rank: int = None):
        self.shards, self.m, self.tp = shards, int(m), tp
        r = self.m if rank is None else int(rank)
        self.layout = shards.layout
        nleaves = len(self.layout.shapes)
        self.classes = (tuple(tp_classes(shards, head_dim))
                        if shards.model > 1 else (VIEW,) * nleaves)
        self.size = shards.sizes[r]
        self._held = shards.held(r)
        self._split = [int(np.prod(shape, dtype=np.int64))
                       for _, shape in self._held]
        self._local = {i: shape for i, shape in self._held
                       if self.classes[i] == VIEW}
        self._piece = {}        # a gathered leaf -> its one block
        for b in shards._blocks[r]:
            if self.classes[b.leaf] != VIEW:
                if b.leaf in self._piece:
                    raise ValueError(f"leaf {b.leaf} is gathered over the "
                                     "model group but cut on two dims")
                self._piece[b.leaf] = b
        self._gathered = [[i for i, c in enumerate(self.classes) if c == k]
                          for k in (WHOLE, PARTIAL)]

    def _placed(self, pieces, i: int, like: torch.Tensor) -> torch.Tensor:
        """Leaf i whole (flat): this rank's piece in place, zeros
        elsewhere."""
        numel = int(self.layout.numels[i])
        if i not in pieces:
            return like.new_zeros(numel)
        b = self._piece[i]
        return torch.nn.functional.pad(
            pieces[i].reshape(b.pre, b.per, b.post),
            (0, 0, b.lo, b.D - b.lo - b.per)).reshape(numel)

    def unflatten(self, w: torch.Tensor):
        if w.shape[-1] != self.size:
            raise ValueError(f"shard has {w.shape[-1]} elements, rank "
                             f"{self.m}'s layout {self.size}")
        return self.tree(self.split(w))

    def split(self, w: torch.Tensor):
        """The shard's held leaves, one block each, as views of ``w``."""
        return torch.split(w, self._split, dim=-1)

    def tree(self, blocks):
        """The model's tree from the shard's held leaves (``split``'s, or
        tensors of their own: a step that takes each leaf's gradient
        apart needs no concatenation of them)."""
        pieces = {i: c for (i, _), c in zip(self._held, blocks)}
        leaves: Dict[int, torch.Tensor] = {
            i: pieces[i].view(shape) for i, shape in self._local.items()}
        runs = [[self._placed(pieces, i, blocks[0]) for i in ids]
                for ids in self._gathered]
        if runs[0] or runs[1]:
            sizes = [sum(int(self.layout.numels[i]) for i in ids)
                     for ids in self._gathered]
            if sizes[1]:
                # the PARTIAL leaves' backward sum is a collective every
                # rank must join, also one that holds no piece of them:
                # one element of its shard, times 0, ties the run to it
                runs[1].append(blocks[0].reshape(-1)[:1] * 0)
                sizes[1] += 1
            whole = tpm.reduce_from_region(torch.cat(runs[0] + runs[1]),
                                           self.tp, "tp_leaf_gather")
            head, tail = torch.split(whole, sizes)
            if sizes[1]:
                tail = tpm.copy_to_region(tail, self.tp,
                                          "tp_leaf_gather")[:-1]
            for ids, run in zip(self._gathered, (head, tail)):
                chunks = torch.split(run, [int(self.layout.numels[i])
                                           for i in ids])
                for i, c in zip(ids, chunks):
                    leaves[i] = c.view(self.layout.shapes[i])
        return tree_map(lambda i: leaves[i], self.layout.skeleton)
