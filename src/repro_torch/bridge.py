"""Trees of numpy arrays <-> torch tensors, and the flat parameter buffer.

The reference keeps parameters as pytrees (nested dicts and lists of
arrays). The port keeps them as ONE contiguous f32 vector of N elements
and hands the model per-leaf views of it (``FlatLayout.unflatten``):

  * leaves are laid out in JAX's leaf order — dict keys sorted, lists in
    order — which is the order the reference's ``tree_vdot`` and its
    per-leaf kernel loop sum in;
  * every leaf keeps the reference's storage layout (conv weights HWIO),
    so the flat vector equals ``np.concatenate([x.ravel() for x in
    jax.tree.leaves(tree)])`` element for element.

A client cohort is then a (K, N) stack whose rows are flat vectors, and
the server step is a pass over that stack.

The decoders keep their parameters as a tree of tensors instead, one
dict per layer: ``lm_params_from_reference`` and
``lm_states_from_reference`` split the reference's stacked layer groups
into that list.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import stack_plan

Tree = Any
Path = Tuple[Any, ...]


def tree_leaves_with_path(tree: Tree, path: Path = ()
                          ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's leaf order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_leaves_with_path(x, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *[r[i] for r in rest])
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # torch wants writable memory; a read-only array (a JAX export) is
    # copied once here — every caller copies the tensor anyway
    a = a if a.flags.writeable else a.copy()
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16 (a bf16 model):
        # torch.from_numpy refuses it; same bits through uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree: Tree) -> Tree:
    """A tree of numpy arrays (or anything ``np.asarray`` takes) -> a tree
    of CPU tensors (copies)."""
    return tree_map(lambda x: _as_tensor(x).clone(), tree)


def to_numpy(tree: Tree) -> Tree:
    """A tree of tensors -> a tree of host numpy arrays (copies)."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy()
                    if isinstance(x, torch.Tensor) else np.array(x), tree)


@dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a parameter tree lives in the flat buffer."""
    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    skeleton: Tree              # the tree with each leaf replaced by its index

    @property
    def numels(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def size(self) -> int:
        return int(sum(self.numels))

    @property
    def leaf_offsets(self) -> torch.Tensor:
        """(L+1,) CPU int64: where each leaf starts in the flat buffer,
        then N — the column segments of the codec's per-leaf scalars."""
        return torch.tensor(np.concatenate([[0], np.cumsum(self.numels)]),
                            dtype=torch.int64)

    def flatten(self, tree: Tree, device=None) -> torch.Tensor:
        """Tree (numpy or torch leaves) -> a new (N,) f32 tensor."""
        leaves = tree_leaves_with_path(tree)
        parts = []
        for (path, leaf), want_path, shape in zip(leaves, self.paths,
                                                  self.shapes):
            t = _as_tensor(leaf)
            if path != want_path or tuple(t.shape) != shape:
                raise ValueError(f"leaf {path} {tuple(t.shape)} does not "
                                 f"match layout {want_path} {shape}")
            parts.append(t.to(device=device, dtype=torch.float32
                              ).reshape(-1))
        if len(parts) != len(self.paths):
            raise ValueError(f"tree has {len(parts)} leaves, layout "
                             f"{len(self.paths)}")
        return torch.cat(parts)

    def unflatten(self, flat: torch.Tensor) -> Tree:
        """(..., N) tensor -> the parameter tree of VIEWS into it, each
        leaf (..., *shape). One ``torch.split``, so autograd through the
        views costs one concatenation, not one N-sized buffer per leaf;
        works under ``torch.func.vmap`` with the stack axis batched."""
        if flat.shape[-1] != self.size:
            raise ValueError(f"flat buffer has {flat.shape[-1]} elements, "
                             f"layout {self.size}")
        lead = tuple(flat.shape[:-1])
        chunks = torch.split(flat, self.numels, dim=-1)
        views = [c.view(lead + s) for c, s in zip(chunks, self.shapes)]
        return tree_map(lambda i: views[i], self.skeleton)

    def to_numpy(self, flat: torch.Tensor) -> Tree:
        return to_numpy(self.unflatten(flat))


def layout_of(tree: Tree) -> FlatLayout:
    pairs = list(tree_leaves_with_path(tree))
    index = {path: i for i, (path, _) in enumerate(pairs)}

    def skel(t, path=()):
        if isinstance(t, dict):
            return {k: skel(t[k], path + (k,)) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(skel(x, path + (i,)) for i, x in enumerate(t))
        return None if t is None else index[path]

    return FlatLayout(paths=tuple(p for p, _ in pairs),
                      shapes=tuple(tuple(np.shape(x)) for _, x in pairs),
                      skeleton=skel(tree))


def load_params(params: Tree, device=None
                ) -> Tuple[torch.Tensor, FlatLayout]:
    """Carry weights across: a parameter tree (the reference's numpy
    params, or the port's own init) -> (flat f32 buffer on ``device``,
    its layout). ``layout.unflatten(flat)`` gives the port's params dict."""
    layout = layout_of(params)
    return layout.flatten(params, device=device), layout


def _unstack_layers(prefix: Tree, stack: Tree, cfg) -> List[Tree]:
    """The reference's (prefix layers, stacked groups) -> one tree per
    layer in execution order: prefix, then group by group, each group's
    ``period`` layers in order (``stack[j]`` has a leading groups axis)."""
    n_prefix, period, groups = stack_plan(cfg)
    if len(prefix) != n_prefix or len(stack) != (period if groups else 0):
        raise ValueError(f"{cfg.name}: {len(prefix)} prefix layers and "
                         f"{len(stack)} stacked, expected {n_prefix} and "
                         f"{period if groups else 0}")
    layers = list(prefix)
    for gi in range(groups):
        layers += [tree_map(lambda x: np.asarray(x)[gi], stack[j])
                   for j in range(period)]
    return layers


def lm_params_from_reference(np_params: Tree, cfg) -> Tree:
    """The reference's ``init_lm`` tree (numpy leaves) -> the port's
    decoder params (transformer module docstring) as CPU tensors: the
    same leaves in the same dtypes (an SSM mixer's ``a_log`` and
    ``d_skip`` stay f32 in a bf16 model), layer by layer."""
    out = {k: to_torch(np_params[k]) for k in ("embed", "final_norm",
                                               "lm_head") if k in np_params}
    out["layers"] = [to_torch(layer) for layer in _unstack_layers(
        np_params["prefix_layers"], np_params["stack"], cfg)]
    return out


def lm_states_from_reference(np_states: Tree, cfg) -> List:
    """The reference's ``init_states`` tree (or a prefill's / decode's
    new states, as numpy) -> the port's list of per-layer states (CPU
    tensors): an attention cache with ``idx`` as a Python int, or an SSM
    state {"conv", "h"} (which has no ``idx``)."""
    out = []
    for c in _unstack_layers(np_states["prefix"], np_states["stack"], cfg):
        if "h" in c:                               # an SSM layer
            out.append(to_torch({k: c[k] for k in ("conv", "h")}))
            continue
        cache = to_torch({k: c[k] for k in ("k", "v", "pos")})
        cache["idx"] = int(np.asarray(c["idx"]))
        out.append(cache)
    return out


__all__: Sequence[str] = (
    "FlatLayout", "layout_of", "lm_params_from_reference",
    "lm_states_from_reference", "load_params", "to_numpy", "to_torch",
    "tree_leaves", "tree_leaves_with_path", "tree_map")
