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
into that list (MoE experts, MLA latents and caches, hybrid stacks
alike), and ``encdec_params_from_reference`` and
``encdec_states_from_reference`` the encoder-decoder's layer-stacked
trees.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

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


def jax_keystr(tree: Tree, path: Path) -> str:
    """``path`` (from ``tree_leaves_with_path(tree)``) spelled as the
    reference's checkpoint manifest spells a key path — ``"/".join(str(
    part))`` of jax's key path parts: ``['name']`` for a dict key (the
    key's repr), ``[i]`` for a list or tuple index."""
    parts = []
    for key in path:
        parts.append(f"[{key!r}]" if isinstance(tree, dict) else f"[{key}]")
        tree = tree[key]
    return "/".join(parts)


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


# ---- trainer state: the port's flat buffers <-> the reference's trees ----
#
# The port keeps every params-shaped state vector flat: (N,), or (C, N)
# for FedVARP's per-client table, (L,) for a codec's per-leaf scalars.
# The reference keeps them as params-shaped trees ((C, *shape) leaves for
# the table, a 0-d scalar per leaf for the codec). These map one onto the
# other bit for bit; the ``*_to_reference`` direction (and
# ``FlatLayout.unflatten``, a flat vector's) returns VIEWS into the flat
# buffers (no copy), so a checkpoint writer can move a large state to the
# host one leaf at a time.


def _is_tree(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flat_from_reference(tree: Tree, layout: FlatLayout,
                        device=None) -> torch.Tensor:
    """A params-shaped tree whose leaves are (..., *shape) -> one new
    (..., N) f32 tensor (the leading dims are the first leaf's); the
    inverse of ``layout.unflatten``."""
    pairs = list(tree_leaves_with_path(tree))
    if [p for p, _ in pairs] != list(layout.paths):
        raise ValueError(f"tree leaves {[p for p, _ in pairs]} do not "
                         f"match the layout's {list(layout.paths)}")
    leaves = [_as_tensor(x) for _, x in pairs]
    lead = tuple(leaves[0].shape[:leaves[0].dim() - len(layout.shapes[0])])
    parts = []
    for t, shape in zip(leaves, layout.shapes):
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"leaf {tuple(t.shape)} is not {lead} + "
                             f"{shape}")
        parts.append(t.to(device=device, dtype=torch.float32
                          ).reshape(lead + (-1,)))
    return torch.cat(parts, dim=-1)


def server_state_to_reference(state: Dict[str, Any], layout: FlatLayout
                              ) -> Dict[str, Any]:
    """The port's server (or server-optimizer) state -> the reference's:
    a 0-d entry (the adaptive rules' step count ``"t"``) stays as it is,
    in its dtype; an (N,) entry (``delta_prev``, ``m``, ``v``) becomes a
    params-shaped tree, a (C, N) one (FedVARP's table ``y``) a tree of
    (C, *shape) leaves — views, not copies."""
    return {k: v if v.dim() == 0 else layout.unflatten(v)
            for k, v in state.items()}


def server_state_from_reference(state: Dict[str, Any], layout: FlatLayout,
                                device=None) -> Dict[str, torch.Tensor]:
    """Inverse of ``server_state_to_reference`` (numpy or torch leaves):
    new tensors on ``device``; a 0-d entry keeps its dtype."""
    single = isinstance(layout.skeleton, int)       # a one-leaf model
    return {k: flat_from_reference(v, layout, device)
            if _is_tree(v) or single else
            _as_tensor(v).clone().to(device) for k, v in state.items()}


def payload_to_reference(payload: Dict[str, torch.Tensor],
                         layout: FlatLayout) -> Dict[str, Tree]:
    """A codec payload {"q": (..., N), "scale": (..., L), "zero": (...,
    L)} -> the reference's {"q": tree of (..., *shape), "scale": tree of
    (...) scalars, "zero": ...} (views; int8/bf16 codes keep their
    dtype)."""
    def per_leaf(v):
        return tree_map(lambda i: v[..., i], layout.skeleton)
    return {"q": layout.unflatten(payload["q"]),
            "scale": per_leaf(payload["scale"]),
            "zero": per_leaf(payload["zero"])}


def payload_from_reference(tree: Dict[str, Tree], layout: FlatLayout,
                           device=None) -> Dict[str, torch.Tensor]:
    """Inverse of ``payload_to_reference``: new tensors, the codes in
    their dtype, the scalars f32."""
    q = [_as_tensor(x) for x in tree_leaves(tree["q"])]
    lead = tuple(q[0].shape[:q[0].dim() - len(layout.shapes[0])])
    codes = torch.cat([t.reshape(lead + (-1,)) for t in q], dim=-1)

    def stack(sub):
        return torch.stack([_as_tensor(x).to(torch.float32)
                            for x in tree_leaves(sub)], dim=-1)
    return {"q": codes.to(device), "scale": stack(tree["scale"]).to(device),
            "zero": stack(tree["zero"]).to(device)}


def _unstack(tree: Tree, n: int) -> List[Tree]:
    """One tree of (n, ...) leaves -> n trees of its slices."""
    return [tree_map(lambda x, i=i: np.asarray(x)[i], tree)
            for i in range(n)]


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
    groups_of = [_unstack(stack[j], groups) for j in range(len(stack))]
    for gi in range(groups):
        layers += [groups_of[j][gi] for j in range(period)]
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


def _state_from_reference(c) -> Dict[str, Any]:
    """One layer's state: an SSM state {"conv", "h"} (no ``idx``), or an
    attention cache (GQA's k/v or MLA's c_kv/k_rope, and pos) with
    ``idx`` as a Python int."""
    if "h" in c:                                   # an SSM layer
        return to_torch({k: c[k] for k in ("conv", "h")})
    cache = to_torch({k: v for k, v in c.items() if k != "idx"})
    cache["idx"] = int(np.asarray(c["idx"]))
    return cache


def lm_states_from_reference(np_states: Tree, cfg) -> List:
    """The reference's ``init_states`` tree (or a prefill's / decode's
    new states, as numpy) -> the port's list of per-layer states (CPU
    tensors)."""
    return [_state_from_reference(c) for c in _unstack_layers(
        np_states["prefix"], np_states["stack"], cfg)]


def encdec_params_from_reference(np_params: Tree, cfg) -> Tree:
    """The reference's ``init_encdec`` tree (numpy leaves; "encoder" and
    "decoder" stacked over layers by its ``vmap``) -> the port's serving
    tree (models/encdec.py): those two as lists of layer trees."""
    out = {k: to_torch(v) for k, v in np_params.items()
           if k not in ("encoder", "decoder")}
    out["encoder"] = [to_torch(t) for t in _unstack(np_params["encoder"],
                                                    cfg.encoder_layers)]
    out["decoder"] = [to_torch(t) for t in _unstack(np_params["decoder"],
                                                    cfg.num_layers)]
    return out


def encdec_states_from_reference(np_states: Tree, cfg) -> List:
    """The reference's ``init_decoder_states`` tree (or a decode's new
    states; leaves stacked over layers) -> the port's list of per-layer
    self-attention caches, ``idx`` a Python int."""
    return [_state_from_reference(c)
            for c in _unstack(np_states, cfg.num_layers)]


__all__: Sequence[str] = (
    "FlatLayout", "encdec_params_from_reference",
    "encdec_states_from_reference", "flat_from_reference", "jax_keystr",
    "layout_of", "lm_params_from_reference", "lm_states_from_reference",
    "load_params", "payload_from_reference", "payload_to_reference",
    "server_state_from_reference", "server_state_to_reference",
    "to_numpy", "to_torch", "tree_leaves", "tree_leaves_with_path",
    "tree_map")
