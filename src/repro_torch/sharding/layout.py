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
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.bridge import FlatLayout
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
