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
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.bridge import FlatLayout, tree_map
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.rules import cohort_leaf_specs, mesh_axes, path_str


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


class ShardLayout:
    """The M shards of a FlatLayout under per-leaf specs (see the module
    docstring). ``specs`` holds one spec per leaf, in the layout's
    order."""

    def __init__(self, layout: FlatLayout, specs: Sequence, model: int,
                 model_axis: str = "model"):
        if len(specs) != len(layout.shapes):
            raise ValueError(f"{len(specs)} specs for {len(layout.shapes)} "
                             "leaves")
        self.layout = layout
        self.model = int(model)
        self.specs = tuple(specs)
        starts = np.concatenate([[0], np.cumsum(layout.numels)])
        self._blocks: List[List[Block]] = [[] for _ in range(self.model)]
        for i, (shape, spec) in enumerate(zip(layout.shapes, specs)):
            dim = next((d for d, ax in enumerate(spec)
                        if ax == model_axis
                        or (isinstance(ax, tuple) and model_axis in ax)),
                       None)
            numel = int(np.prod(shape, dtype=np.int64))
            for m in range(self.model):
                if dim is None:
                    cut = (1, numel, 1, 0, numel) if m == 0 else None
                else:
                    d = int(shape[dim])
                    per = d // self.model
                    cut = (int(np.prod(shape[:dim], dtype=np.int64)), d,
                           int(np.prod(shape[dim + 1:], dtype=np.int64)),
                           m * per, per)
                blocks = self._blocks[m]
                if cut is None or cut[0] * cut[4] * cut[2] == 0:
                    continue
                at = blocks[-1].at + blocks[-1].size if blocks else 0
                blocks.append(Block(i, int(starts[i]), *cut, at))
        self.sizes = tuple(sum(b.size for b in bl) for bl in self._blocks)
        if sum(self.sizes) != layout.size:
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

    # ---- per shard ----

    @property
    def max_size(self) -> int:
        return max(self.sizes)

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

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The (..., N) tensor from its M (..., N_m) shards."""
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
                            for m in range(self.model)])


# ---------------- the tensor-parallel view of a shard ----------------

VIEW, WHOLE, PARTIAL = "view", "whole", "partial"

# the leaves Megatron splits: regex over the "/"-joined path -> the
# split dim, counted from the end (the rules' convention), and whether
# the split must fall on attention-head boundaries
MEGATRON = (
    (r"(wq|wk|wv)/[wb]$", -1, True),         # column-parallel
    (r"wo/w$", -2, True),                    # row-parallel
    (r"(gate|up)/[wb]$", -1, False),         # column-parallel
    (r"down/w$", -2, False),                 # row-parallel
    (r"(^|/)embed$", -2, False),             # vocab-parallel
    (r"lm_head/w$", -1, False),
)
_KV = r"(wk|wv)/[wb]$"
# the leaves the route needs split: attention and MLP run in parallel
_REQUIRED = (r"wq/w$", r"wo/w$", r"(gate|up)/w$", r"down/w$")


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
    so its gradient is partial and is summed over the group. WHOLE for
    every other leaf — norms, ``wo/b``, ``down/b``, and ``embed`` or
    ``lm_head`` when M does not divide the vocabulary — which every rank
    computes alike, so each keeps its slice of the same gradient. Raises
    when a query, output or MLP projection is not split so: the route
    needs M to divide the query heads and the MLP width."""
    layout = shards.layout
    out = []
    for i, (shape, spec) in enumerate(zip(layout.shapes, shards.specs)):
        path = path_str(layout.paths[i])
        md = megatron_dim(path)
        cls = WHOLE
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
                    "query heads and the MLP width")
        out.append(cls)
    return out


class TPView:
    """Model rank ``m``'s shard as the tree the model runs on
    (sharding/tensor_parallel.py). ``unflatten(w)`` of the rank's (N_m,)
    vector — a row of the cohort's (K, N_m) stack under vmap — gives the
    layout's tree with every VIEW leaf the rank's slice in its local
    shape (the Megatron dim cut M-fold) and every other leaf whole.

    The shard is cut into its blocks by one ``torch.split`` (autograd
    then pays one concatenation). The WHOLE and PARTIAL leaves are
    gathered in one reduce-from-region over the model group
    ("tp_leaf_gather"): each rank's pieces placed in a zero vector of
    the leaves' whole size, summed (exact: one rank holds each element).
    Backward, a WHOLE leaf's gradient is the same on every rank and each
    keeps its slice; the PARTIAL leaves pass a copy-to-region, so their
    gradient is summed over the group before the rank keeps its slice.
    A leaf the layout gives to model rank 0 alone is WHOLE: every rank
    computes with it, rank 0 keeps its gradient."""

    def __init__(self, shards: ShardLayout, m: int, head_dim: int, tp):
        self.shards, self.m, self.tp = shards, int(m), tp
        self.layout = shards.layout
        self.classes = tuple(tp_classes(shards, head_dim))
        self.size = shards.sizes[self.m]
        self._blocks = shards._blocks[self.m]
        self._split = [b.size for b in self._blocks]
        self._local = {}        # VIEW leaf -> its local shape
        for b in self._blocks:
            if self.classes[b.leaf] == VIEW:
                shape = list(self.layout.shapes[b.leaf])
                path = path_str(self.layout.paths[b.leaf])
                shape[megatron_dim(path)[0] % len(shape)] = b.per
                self._local[b.leaf] = tuple(shape)
        self._gathered = [[i for i, c in enumerate(self.classes) if c == k]
                          for k in (WHOLE, PARTIAL)]

    def _placed(self, pieces, i: int, like: torch.Tensor) -> torch.Tensor:
        """Leaf i whole (flat): this rank's piece in place, zeros
        elsewhere."""
        numel = int(self.layout.numels[i])
        if i not in pieces:
            return like.new_zeros(numel)
        b, piece = pieces[i]
        return torch.nn.functional.pad(
            piece.view(b.pre, b.per, b.post),
            (0, 0, b.lo, b.D - b.lo - b.per)).reshape(numel)

    def unflatten(self, w: torch.Tensor):
        if w.shape[-1] != self.size:
            raise ValueError(f"shard has {w.shape[-1]} elements, rank "
                             f"{self.m}'s layout {self.size}")
        return self.tree(self.split(w))

    def split(self, w: torch.Tensor):
        """The shard's blocks, one a held leaf, as views of ``w``."""
        return torch.split(w, self._split, dim=-1)

    def tree(self, blocks):
        """The model's tree from the shard's blocks (``split``'s, or
        tensors of their own: a step that takes each block's gradient
        apart needs no concatenation of them)."""
        pieces = {b.leaf: (b, c) for b, c in zip(self._blocks, blocks)}
        leaves: Dict[int, torch.Tensor] = {
            i: pieces[i][1].view(shape) for i, shape in self._local.items()}
        runs = [[self._placed(pieces, i, blocks[0]) for i in ids]
                for ids in self._gathered]
        if runs[0] or runs[1]:
            sizes = [sum(int(self.layout.numels[i]) for i in ids)
                     for ids in self._gathered]
            whole = tpm.reduce_from_region(torch.cat(runs[0] + runs[1]),
                                           self.tp, "tp_leaf_gather")
            head, tail = torch.split(whole, sizes)
            if sizes[1]:
                tail = tpm.copy_to_region(tail, self.tp, "tp_leaf_gather")
            for ids, run in zip(self._gathered, (head, tail)):
                chunks = torch.split(run, [int(self.layout.numels[i])
                                           for i in ids])
                for i, c in zip(ids, chunks):
                    leaves[i] = c.view(self.layout.shapes[i])
        return tree_map(lambda i: leaves[i], self.layout.skeleton)

