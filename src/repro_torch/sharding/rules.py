"""Partition specs for every parameter, input and cache class, and which
rows of the cohort a rank holds; counterpart of repro/sharding/rules.py.

**The per-leaf rules** (the reference's DESIGN.md §8): name-based rules
with divisibility guards — a dim is sharded only if the axis size
divides it, else it replicates. Rules are written from the END of the
shape, so one rule covers plain leaves and layer-stacked ones. A path is
the reference's ``"/"``-joined key path (``path_str``: a dict key as
itself, a list index as its number), so the same regexes match the
port's trees, which keep the reference's structure and shapes.

A spec is the port's own small tuple type, ``PartitionSpec`` (``P``):
per tensor dim an axis name, a tuple of axis names, or None. A mesh is
anything with axis names and a shape: the port's ``DeviceMesh``
(``mesh_dim_names``, ``mesh.shape``) or a shape-only stand-in with the
reference's ``axis_names`` and ``devices.shape``. ``to_named`` maps a
spec onto DTensor placements (``Shard(d)`` / ``Replicate()``) of a mesh.
Pure Python: no device, no process group.

**The model axis of the cohort round** (``cohort_param_specs``,
``cohort_state_specs``): the reference shards params and server state
per leaf over ``model`` and lets GSPMD partition the round. The port
writes that layout out by hand (sharding/layout.ShardLayout, the round
in core/round.py), from these same specs.

**The client axis**: the port runs one process per rank, and the rank at
client coordinate c of a C-wide client axis holds the c-th contiguous
slice of the padded cohort (the reference lays its process-spanning
clients axis out in process order, which gives the same slices). On a
two-axis mesh the M model ranks of a client slice split its rows for
local training (``model_row_split``). Hierarchical edges split the same
padded rows into equal contiguous groups, so a slice's rows fall into
one or more EDGE PIECES: the intersections of its rows with the edge
groups. The round folds each piece with one kernel launch
(core/feddpc.py).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.bridge import tree_leaves_with_path

Tree = Any


class PartitionSpec(tuple):
    """Per tensor dim: an axis name, a tuple of axis names, or None.
    ``P()`` replicates a tensor of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, and the DTensor placements it gives: one per
    mesh dim, ``Shard(d)`` where the spec puts that axis on tensor dim
    d, ``Replicate()`` elsewhere."""
    mesh: Any
    spec: PartitionSpec
    placements: tuple


@dataclass(frozen=True)
class ShardingPolicy:
    model_axis: str = "model"
    batch_axes: Tuple[str, ...] = ("data",)      # ("pod","data") multi-pod
    # single axis name, or a TUPLE of axes (multi-pod expert parallelism
    # spans pod x data); None -> experts over model only
    expert_axis: Optional[object] = "data"
    shard_embed: bool = True
    seq_axis: Optional[str] = None               # sequence parallelism
    fsdp_dense: bool = False                     # dense d_ff/vocab over data


# rule := (regex over the "/"-joined path, spec from the end); an entry is
# an axis name, None, or the token "EXPERT"
def _rules(pol: ShardingPolicy):
    m = pol.model_axis
    d0 = pol.batch_axes[-1] if pol.fsdp_dense else None
    return [
        # --- embeddings / head ---
        (r"(^|/)embed$",                 (m, None)),         # (V, D)
        (r"lm_head/w$",                  (d0, m)),           # (D, V)
        (r"head/w$",                     (None, None)),      # vision head
        # --- attention (GQA + MLA + cross) ---
        (r"(wq|wk|wv)/w$",               (d0, m)),
        (r"(wq|wk|wv)/b$",               (m,)),
        (r"wo/w$",                       (m, d0)),
        (r"q_up/w$",                     (None, m)),
        (r"(k_up|v_up)/w$",              (None, m)),
        (r"(q_down|kv_down)/w$",         (None, None)),
        # --- MoE experts (E, D, F) / (E, F, D) ---
        (r"mlp/(gate|up)$",              ("EXPERT", None, m)),
        (r"mlp/down$",                   ("EXPERT", m, None)),
        (r"router/w$",                   (None, None)),
        (r"shared/(gate|up)/w$",         (d0, m)),
        (r"shared/down/w$",              (m, d0)),
        # --- dense MLP ---
        (r"(gate|up)/w$",                (d0, m)),
        (r"(gate|up)/b$",                (m,)),
        (r"down/w$",                     (m, d0)),
        # --- mamba ---
        (r"in_proj/w$",                  (None, m)),
        (r"conv_w$",                     (None, m)),
        (r"conv_b$",                     (m,)),
        (r"x_proj/w$",                   (m, None)),
        (r"dt_proj/w$",                  (None, m)),
        (r"dt_proj/b$",                  (m,)),
        (r"a_log$",                      (m, None)),
        (r"d_skip$",                     (m,)),
        (r"out_proj/w$",                 (m, None)),
    ]


def _leaf_spec(path: str, shape, pol: ShardingPolicy,
               axis_sizes: Dict[str, int]) -> PartitionSpec:
    """The first rule matching ``path``, aligned to the end of ``shape``,
    with the divisibility and duplicate-axis guards; P() if none
    matches."""
    for pat, spec_end in _rules(pol):
        if not re.search(pat, path):
            continue
        spec_end = [pol.expert_axis if s == "EXPERT" else s
                    for s in spec_end]
        n, k = len(shape), len(spec_end)
        if k > n:
            spec_end = spec_end[k - n:]
        full = [None] * (n - len(spec_end)) + spec_end
        used = set()
        out = []
        for dim, ax in zip(shape, full):
            axes = ax if isinstance(ax, tuple) else (ax,)
            if ax is None or any(a in used for a in axes):
                out.append(None)
                continue
            sizes = [axis_sizes.get(a) for a in axes]
            if any(s is None for s in sizes) or dim % int(np.prod(sizes)):
                out.append(None)
            else:
                out.append(ax)
                used.update(axes)
        return P(*out)
    return P()          # replicate (norms, scalars, small biases)


# ---------------- trees, paths, meshes ----------------

def path_str(path) -> str:
    """A port tree path (``bridge.tree_leaves_with_path``) spelled as the
    reference's rules spell it: its keys joined by "/"."""
    return "/".join(str(k) for k in path)


def _shape(leaf) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    return tuple(int(d) for d in (np.shape(leaf) if shape is None
                                  else shape))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a port DeviceMesh or of a shape-only stand-in
    with the reference's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        shape = tuple(mesh.mesh.shape)
    else:
        names, shape = mesh.axis_names, tuple(mesh.devices.shape)
    return dict(zip(names, (int(s) for s in shape)))


def _unflatten(tree: Tree, leaves: List[Any]) -> Tree:
    """``tree``'s structure with its leaves (in JAX's order) replaced by
    ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)) and not isinstance(t, P):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    return build(tree)


def spec_leaves(tree: Tree) -> List[PartitionSpec]:
    out = []

    def walk(t):
        if isinstance(t, P):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
    walk(tree)
    return out


def map_specs(fn, specs: Tree) -> Tree:
    """``fn`` over every spec of a spec tree (a spec is a leaf)."""
    return _unflatten(specs, [fn(s) for s in spec_leaves(specs)])


def _default_policy(mesh, pol: Optional[ShardingPolicy]) -> ShardingPolicy:
    return pol or ShardingPolicy(batch_axes=tuple(
        a for a in mesh_axes(mesh) if a != "model"))


# ---------------- params, inputs, serve states ----------------

def param_specs(params: Tree, mesh,
                pol: Optional[ShardingPolicy] = None) -> Tree:
    pol = _default_policy(mesh, pol)
    pairs = [(path_str(p), _shape(x))
             for p, x in tree_leaves_with_path(params)]
    return _unflatten(params, leaf_specs(pairs, mesh_axes(mesh), pol))


def leaf_specs(paths_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
               axis_sizes: Dict[str, int],
               pol: ShardingPolicy) -> List[PartitionSpec]:
    """``param_specs`` on (path, shape) pairs: the name rules alone (a
    leaf no rule shards replicates)."""
    return [_leaf_spec(pstr, shape, pol, axis_sizes)
            for pstr, shape in paths_shapes]


def _batch_spec(batch_size: int, pol: ShardingPolicy, axis_sizes):
    """The largest prefix of batch_axes whose product divides
    batch_size."""
    axes = []
    prod = 1
    for ax in pol.batch_axes:
        if batch_size % (prod * axis_sizes[ax]) == 0:
            axes.append(ax)
            prod *= axis_sizes[ax]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_specs(batch: Tree, mesh,
                pol: Optional[ShardingPolicy] = None) -> Tree:
    """Inputs (tokens/labels/frames/patch_embeds): dim 0 over the batch
    axes."""
    pol = _default_policy(mesh, pol)
    sizes = mesh_axes(mesh)

    def one(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return P(_batch_spec(shape[0], pol, sizes),
                 *([None] * (len(shape) - 1)))
    return _unflatten(batch, [one(x) for _, x in
                              tree_leaves_with_path(batch)])


def state_specs(states: Tree, mesh,
                pol: Optional[ShardingPolicy] = None) -> Tree:
    """Serve states (KV caches, SSM states, MLA latent caches), by the
    leaf's name: k/v (…, B, C, KV, HD) batch, then KV over model when
    divisible, else C; pos (…, B, C) batch; c_kv/k_rope (…, B, C, R)
    batch, C over model; conv (…, B, W, d_in) and h (…, B, d_in, st)
    batch, d_in over model; enc_out batch; anything else replicated.
    Leading stack dims are unsharded."""
    pol = _default_policy(mesh, pol)
    sizes = mesh_axes(mesh)
    msize = sizes[pol.model_axis]
    m = pol.model_axis

    def spec_for(pstr: str, shape) -> P:
        name = pstr.split("/")[-1]
        nd = len(shape)
        if nd == 0:
            return P()
        if name in ("k", "v") and nd >= 4:
            b, c, kv, _ = shape[-4:]
            bspec = _batch_spec(b, pol, sizes)
            if kv % msize == 0:
                end = [bspec, None, m, None]
            elif c % msize == 0:
                end = [bspec, m, None, None]
            else:
                end = [bspec, None, None, None]
        elif name == "pos" and nd >= 2:
            end = [_batch_spec(shape[-2], pol, sizes), None]
        elif name in ("c_kv", "k_rope") and nd >= 3:
            b, c, _ = shape[-3:]
            end = [_batch_spec(b, pol, sizes),
                   m if c % msize == 0 else None, None]
        elif name == "conv" and nd >= 3:
            b, _, din = shape[-3:]
            end = [_batch_spec(b, pol, sizes), None,
                   m if din % msize == 0 else None]
        elif name == "h" and nd >= 3:
            b, din, _ = shape[-3:]
            end = [_batch_spec(b, pol, sizes),
                   m if din % msize == 0 else None, None]
        elif name == "enc_out" and nd >= 3:
            end = [_batch_spec(shape[-3], pol, sizes), None, None]
        else:
            return P(*([None] * nd))
        return P(*([None] * (nd - len(end)) + end))

    return _unflatten(states, [spec_for(path_str(p), _shape(x)) for p, x
                               in tree_leaves_with_path(states)])


def _placements(spec: PartitionSpec, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dim = next((d for d, ax in enumerate(spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def to_named(specs: Tree, mesh) -> Tree:
    """Every spec of a spec tree (or one spec) on ``mesh``, with its
    DTensor placements."""
    one = lambda s: NamedSharding(mesh, s, _placements(s, mesh))
    return one(specs) if isinstance(specs, P) else map_specs(one, specs)


# ---------------- the cohort (simulation FL) round ----------------

def padded_rows(k: int, world: int) -> int:
    """K padded up to a multiple of the client axis."""
    return -(-int(k) // int(world)) * int(world)


def local_row_range(rank: int, world: int, nrows: int) -> Tuple[int, int]:
    """[lo, hi) of the ``nrows`` cohort rows that client coordinate
    ``rank`` of ``world`` holds. ``nrows`` must be a multiple of ``world``
    (the padded cohort); a single process holds (0, nrows)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if nrows % world:
        raise ValueError(f"{nrows} rows do not split over {world} ranks; "
                         "pad the cohort (padded_rows)")
    per = nrows // world
    return rank * per, (rank + 1) * per


def model_row_split(lo: int, hi: int, model: int) -> List[Tuple[int, int]]:
    """The rows [lo, hi) of a client slice split over its ``model`` ranks
    for local training, contiguous and as even as they go (5 rows over 2
    ranks: 3 + 2)."""
    per, extra = divmod(hi - lo, model)
    out, a = [], lo
    for m in range(model):
        b = a + per + (m < extra)
        out.append((a, b))
        a = b
    return out


def edge_pieces(lo: int, hi: int, nrows: int,
                edges: Optional[int] = None) -> List[Tuple[int, int]]:
    """The rows [lo, hi) cut at the boundaries of ``edges`` equal groups
    of ``nrows`` rows, as global [a, b) ranges in row order; without
    edges, [(lo, hi)]."""
    if not edges or edges <= 1:
        return [(lo, hi)]
    if nrows % edges:
        raise ValueError(f"edges={edges} must divide the padded cohort "
                         f"({nrows} rows)")
    per = nrows // edges
    out = []
    a = lo
    while a < hi:
        b = min(hi, (a // per + 1) * per)
        out.append((a, b))
        a = b
    return out


def cohort_leaf_specs(paths_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                      axis_sizes: Dict[str, int],
                      client_axis: str = "clients",
                      model_axis: str = "model",
                      pol: Optional[ShardingPolicy] = None
                      ) -> List[PartitionSpec]:
    """``cohort_param_specs`` on (path, shape) pairs: the name rules
    first, then a leaf they leave fully replicated shards its LAST
    model-divisible dim; nothing divisible replicates."""
    pol = pol or ShardingPolicy(model_axis=model_axis,
                                batch_axes=(client_axis,), expert_axis=None)
    msize = axis_sizes.get(model_axis, 1)
    out = []
    for pstr, shape in paths_shapes:
        spec = _leaf_spec(pstr, shape, pol, axis_sizes)
        if msize > 1 and not any(s is not None for s in spec):
            dims = [None] * len(shape)
            for i in range(len(shape) - 1, -1, -1):
                if shape[i] % msize == 0:
                    dims[i] = model_axis
                    break
            spec = P(*dims)
        out.append(spec)
    return out


def cohort_param_specs(params: Tree, mesh, client_axis: str = "clients",
                       model_axis: str = "model",
                       pol: Optional[ShardingPolicy] = None) -> Tree:
    """Per-leaf ``model``-axis specs for the two-axis cohort round: the
    name rules (Megatron layout for LM-named leaves), else the last
    model-divisible dim. The client axis never appears in a param spec:
    the global model is the same on every client slice."""
    pairs = [(path_str(p), _shape(x))
             for p, x in tree_leaves_with_path(params)]
    return _unflatten(params, cohort_leaf_specs(
        pairs, mesh_axes(mesh), client_axis, model_axis, pol))


def cohort_state_specs(server_state: Tree, params: Tree, mesh,
                       client_axis: str = "clients",
                       model_axis: str = "model",
                       pol: Optional[ShardingPolicy] = None) -> Tree:
    """Model-axis specs for server state, co-varying with the params'
    layout: a tree mirroring the params (``delta_prev``, moments) takes
    the matching param leaf's spec, a per-client table with a leading
    ``num_clients`` dim (FedVARP's ``y``) keeps that dim replicated and
    the leaf's spec after it, and anything else (scalars) replicates.
    ``<key>/<param path>`` is looked up as ``<param path>``."""
    pspecs = spec_leaves(cohort_param_specs(params, mesh, client_axis,
                                             model_axis, pol))
    by_path = {path_str(p): (_shape(x), spec) for (p, x), spec in
               zip(tree_leaves_with_path(params), pspecs)}
    specs = []
    for path, leaf in tree_leaves_with_path(server_state):
        pstr = path_str(path)
        rest = pstr.split("/", 1)[1] if "/" in pstr else None
        shape = _shape(leaf)
        ent = by_path.get(rest)
        if ent is None:
            specs.append(P())
        elif shape == ent[0]:
            specs.append(ent[1])
        elif shape[1:] == ent[0]:
            specs.append(P(None, *ent[1]))
        else:
            specs.append(P())
    return _unflatten(server_state, specs)


def _two_axis(mesh, client_axis, model_axis) -> bool:
    sizes = mesh_axes(mesh)
    if client_axis not in sizes:
        raise ValueError(f"mesh {tuple(sizes)} has no {client_axis!r} axis")
    return sizes.get(model_axis, 1) > 1


def cohort_round_shardings(mesh, client_axis: str = "clients", *,
                           model_axis: str = "model",
                           params: Optional[Tree] = None,
                           server_state: Optional[Tree] = None):
    """(in, out) shardings of the cohort round (server_state, params,
    batches, masks, client_ids) -> (new_params, new_state, losses, diag):
    the client-stacked inputs over ``client_axis``; on a 1-D client mesh
    params and state replicate, on a two-axis mesh they take the per-leaf
    ``cohort_param_specs`` / ``cohort_state_specs``, which need the
    ``params`` and ``server_state`` templates (shapes only) and raise
    without them."""
    two_axis = _two_axis(mesh, client_axis, model_axis)
    if two_axis and (params is None or server_state is None):
        raise ValueError(
            f"mesh carries a {model_axis!r} axis of size "
            f"{mesh_axes(mesh)[model_axis]}: the two-axis cohort round "
            "needs params/server_state templates for per-leaf specs")
    rep = to_named(P(), mesh)
    cli = to_named(P(client_axis), mesh)
    if not two_axis:
        return (rep, rep, cli, cli, cli), (rep, rep, cli, rep)
    p_sh = to_named(cohort_param_specs(params, mesh, client_axis,
                                       model_axis), mesh)
    s_sh = to_named(cohort_state_specs(server_state, params, mesh,
                                       client_axis, model_axis), mesh)
    return (s_sh, p_sh, cli, cli, cli), (p_sh, s_sh, cli, rep)


def codec_payload_specs(param_specs: Tree, lead) -> Tree:
    """Specs of a codec wire dict {"q", "scale", "zero"} over deltas of
    the param layout ``param_specs``: the codes keep the leaf's layout
    after the leading axis ``lead`` (the client axis of a cohort stack,
    None for the arrival buffer); the per-leaf scalars carry only the
    leading axis."""
    return {"q": map_specs(lambda s: P(lead, *s), param_specs),
            "scale": map_specs(lambda s: P(lead), param_specs),
            "zero": map_specs(lambda s: P(lead), param_specs)}


def async_round_shardings(mesh, client_axis: str = "clients", *,
                          model_axis: str = "model",
                          params: Optional[Tree] = None,
                          server_state: Optional[Tree] = None,
                          codec_payload: bool = False):
    """Shardings of the buffered-async engine's two steps,
    wave_update (params, server_state, batches, masks) -> (deltas,
    losses) and fold (server_state, params, deltas (B, ...), ids,
    weights) -> (new_params, new_state, diag): the wave side as the sync
    round's, the fold's arrival buffer with its leading dim replicated
    (only the model dims stay partitioned), the codec payload's specs
    with ``codec_payload``. Returns (wave_in, wave_out, fold_in,
    fold_out)."""
    two_axis = _two_axis(mesh, client_axis, model_axis)
    rep = to_named(P(), mesh)
    cli = to_named(P(client_axis), mesh)
    if not two_axis:
        return ((rep, rep, cli, cli), (cli, cli),
                (rep, rep, rep, rep, rep), (rep, rep, rep))
    if params is None or server_state is None:
        raise ValueError(
            f"mesh carries a {model_axis!r} axis of size "
            f"{mesh_axes(mesh)[model_axis]}: the two-axis async round "
            "needs params/server_state templates for per-leaf specs")
    pspecs = cohort_param_specs(params, mesh, client_axis, model_axis)
    p_sh = to_named(pspecs, mesh)
    s_sh = to_named(cohort_state_specs(server_state, params, mesh,
                                       client_axis, model_axis), mesh)
    if codec_payload:
        d_sh = to_named(codec_payload_specs(pspecs, client_axis), mesh)
        buf_sh = to_named(codec_payload_specs(pspecs, None), mesh)
    else:
        d_sh = to_named(map_specs(lambda s: P(client_axis, *s), pspecs),
                        mesh)
        buf_sh = to_named(map_specs(lambda s: P(None, *s), pspecs), mesh)
    return ((p_sh, s_sh, cli, cli), (d_sh, cli),
            (s_sh, p_sh, buf_sh, rep, rep), (p_sh, s_sh, rep))
