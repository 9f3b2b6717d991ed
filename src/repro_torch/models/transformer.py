"""Decoder-only transformer stack (counterpart of repro/models/transformer.py)
for every family the reference builds from an ArchConfig: dense GQA, MLA
(DeepSeek-V2), MoE MLPs (DeepSeek-V2, Kimi-K2: after ``first_dense_layers``
dense layers; Jamba: every ``moe_every``-th layer), pure SSM (a Mamba-1
mixer is the whole layer, as in Falcon-Mamba), the hybrid (Jamba: an
attention mixer every ``attn_every``-th layer, Mamba elsewhere) and the
VLM (a trunk after a prefix of patch embeddings from the stubbed vision
tower, models/frontend.py). Each layer is a (mixer kind, is_moe) spec
(``layer_specs``).

The reference runs the periodic part of the stack with ``lax.scan`` over
stacked groups (``stack_plan``: dense -> prefix 0, period 1; DeepSeek and
Kimi -> 1 dense prefix layer, then period 1; Jamba -> period 8). The port
loops over the layers in Python, in the reference's execution order
(prefix layers, then group by group), and takes its parameters in either
of two trees:

  serving  {"embed": (V, D), "final_norm": {...}, "lm_head": {...} unless
           tied, "layers": [{"norm1", "mixer", "norm2", "mlp"}, ...]}
           (an SSM arch's layer is {"norm1", "mixer"}; an MoE layer's
           "mlp" is models/moe.py's tree) — ``init_lm`` from a
           torch.Generator;
  training the reference's own tree: "prefix_layers" (a tuple of layer
           dicts) and "stack" (a tuple of ``period`` layer dicts whose
           leaves carry a leading groups axis) in place of "layers" —
           ``init_lm`` from a jax_prng key, the reference's numbers. The
           flat vector, checkpoint key paths and leaf order are then the
           reference's; the forward reads layer j of group g as views
           ``stack[j][g]``, never a copy.

  states = [per-layer attention cache (attention.init_cache: GQA's K/V
            or MLA's latent) or SSM state {"conv", "h"}
            (ssm.init_ssm_state), ...]

Modes: a full-sequence forward (training: ``loss_fn``), prefill (writes
the caches and states) and decode (S = 1 against them). ``lm_forward``
returns the MoE layers' summed aux loss, which ``loss_fn`` adds to the
reference's causal-LM cross entropy. ``loss_fn`` is on the training
route: attention by the reference's rule between its plain einsum and
blocked forms (``attention.sdpa(impl="plain")``) and the Mamba mixer
through its plain scan, on every device — neither hand-written kernel
has a backward, nor has the reference's (attention.py's docstring). The
MoE layers route their tokens in ``moe_groups`` groups (models/moe.py,
"gshard"), tensor-parallel over a model group with ``tp``; or, with
``moe_impl="ep"`` and ``moe_mesh`` a (data, model) mesh, expert-parallel
(models/moe_ep.py): each rank runs the forward on its rows of the batch
and its experts, the rest of the layer Megatron over the mesh's model
axis, and ``loss_fn`` is the rank's share of the whole batch's loss.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_ep as moe_ep_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, fold_rng,
                                       init_linear, init_mlp, init_norm,
                                       linear, normal, rng_device,
                                       split_rng)
from repro_torch.sharding import tensor_parallel as tpm

REMATS = ("none", "full")


# ---------------- stack plan ----------------

def layer_specs(cfg) -> Tuple[Tuple[str, bool], ...]:
    kinds = cfg.layer_kinds()
    return tuple((kinds[i], cfg.layer_is_moe(i))
                 for i in range(cfg.num_layers))


def stack_plan(cfg) -> Tuple[int, int, int]:
    """-> (prefix_layers, period, groups) with prefix + period*groups == L."""
    specs = layer_specs(cfg)
    n = len(specs)
    for prefix in range(0, n):
        rest = specs[prefix:]
        if not rest:
            break
        for period in range(1, min(len(rest), 16) + 1):
            if len(rest) % period:
                continue
            if all(rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period, len(rest) // period
    return n, 0, 0          # fully heterogeneous: all layers in prefix


_MODALITY = {"vlm": "vision", "audio": "audio"}     # arch_type -> modality


def _check_config(cfg):
    """The arch's modality must be its family's: text, but for a VLM and
    the audio encoder-decoder (whose decoder the LM CLI trains as a
    decoder-only stack, as the reference's CLI does); a pure-SSM stack
    has no MLP, so no MoE layer."""
    want = _MODALITY.get(cfg.arch_type, "text")
    if cfg.modality != want:
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} with modality="
            f"{cfg.modality!r} is not a family the port builds (expected "
            f"{want!r})")
    if cfg.arch_type == "ssm" and cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: a pure-SSM stack has no MLP, so no layer with "
            "MoE")


MOE_IMPLS = ("gshard", "ep")


def _mesh_contexts(moe_mesh, ep, tp):
    """(ep, tp) of the expert-parallel forward: the given contexts, the
    missing ones found from ``moe_mesh`` (None for an axis of one
    rank)."""
    if moe_mesh is None:
        raise ValueError("moe_impl='ep' runs over a (data, model) mesh: "
                         "pass moe_mesh (launch/mesh.make_debug_mesh)")
    if ep is None or tp is None:
        ep_m, tp_m = moe_ep_mod.contexts(moe_mesh)
        ep = ep_m if ep is None else ep
        tp = tp_m if tp is None else tp
    return ep, tp


def _check_moe_impl(moe_impl: str):
    """"gshard" (models/moe.py) or "ep" (models/moe_ep.py, over a mesh:
    ``_mesh_contexts``), in training and in serving alike."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl={moe_impl!r}: one of {MOE_IMPLS}")


# ---------------- single layer ----------------

def _init_layer(rng, cfg, spec, dtype):
    kind, is_moe = spec
    dev = rng_device(rng)
    ks = split_rng(rng, 4)
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev)}
    if kind == "attn":
        p["mixer"] = attn_mod.init_attention(ks[0], cfg, dtype)
    else:
        p["mixer"] = ssm_mod.init_mamba(ks[0], cfg, dtype)
    if cfg.arch_type == "ssm":          # the mamba block IS the layer
        return p
    p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    if is_moe:
        p["mlp"] = moe_mod.init_moe(ks[1], cfg, dtype)
    else:
        p["mlp"] = init_mlp(ks[1], cfg.mlp, cfg.d_model, cfg.d_ff, dtype,
                            cfg.mlp_bias)
    return p


def _layer_forward(cfg, spec, p, x, positions, state, *, window, attn_impl,
                   ssm_impl, moe_groups, shard_fn=None, tp=None,
                   moe_impl="gshard", moe_mesh=None, ep=None):
    """-> (x, new_state, aux): aux is the MoE layer's scaled aux loss, or
    None for a layer without MoE. ``tp``: the tensor-parallel layer (the
    mixer — GQA or MLA attention, or the Mamba mixer —, MLP and experts
    in Megatron's form); ``moe_impl="ep"``: the MoE layer
    expert-parallel over ``moe_mesh`` (``ep`` its expert axis's
    context)."""
    kind, is_moe = spec
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "attn":
        mixed, new_state = attn_mod.attention_forward(
            cfg, p["mixer"], h, positions, window=window, cache=state,
            impl=attn_impl, tp=tp)
    else:
        mixed, new_state = ssm_mod.mamba_forward(cfg, p["mixer"], h,
                                                 state=state, impl=ssm_impl,
                                                 tp=tp)
    x = x + mixed
    if cfg.arch_type == "ssm":
        return x, new_state, None
    h2 = apply_norm(cfg.norm, p["norm2"], x)
    if is_moe and moe_impl == "ep":
        out, aux = moe_ep_mod.moe_forward_ep(cfg, p["mlp"], h2,
                                             mesh=moe_mesh, ep=ep, tp=tp)
        return x + out, new_state, aux
    if is_moe:
        out, aux = moe_mod.moe_forward(cfg, p["mlp"], h2, groups=moe_groups,
                                       shard_fn=shard_fn, tp=tp)
        return x + out, new_state, aux
    return x + apply_mlp(cfg.mlp, p["mlp"], h2, tp), new_state, None


# ---------------- parameter trees ----------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


def _stack_trees(trees):
    """Trees of one structure -> one tree whose leaves are the stacked
    leaves (a new leading axis), as ``jax.vmap`` of an init returns."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def unstack(tree, n: int) -> List:
    """[the tree of every leaf's ``leaf[g]``, for g < n]: views, each
    stacked leaf unbound once. Its gradient is then one stack of the n
    pieces' gradients; a view ``leaf[g]`` taken a layer at a time would
    give each layer's backward a zero tensor of the whole stacked leaf
    to add up, bytes that grow with the square of the depth."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(p[g] for p in parts) for g in range(n)]
    pieces = torch.unbind(tree, 0)
    if len(pieces) != n:
        raise ValueError(f"a stacked leaf of {len(pieces)} for {n} layers")
    return list(pieces)


def layer_params(cfg, params) -> List:
    """The per-layer parameter trees in execution order, from either tree
    (module docstring): the serving tree's list, or views ``stack[j][g]``
    of the reference's stacked groups (``unstack``; under
    ``torch.func.vmap`` too)."""
    if "layers" in params:
        return list(params["layers"])
    _, period, groups = stack_plan(cfg)
    stacks = [unstack(params["stack"][j], groups) for j in range(period)]
    layers = list(params["prefix_layers"])
    for g in range(groups):
        layers += [stacks[j][g] for j in range(period)]
    return layers


# ---------------- full model ----------------

def init_lm(cfg, rng, dtype=None):
    """Parameters with the reference's distributions: embed N(0, 0.02^2),
    linear N(0, 1/fan_in), zero biases, unit norm scales.

    ``rng`` a torch.Generator: the serving tree on its device (drawn in
    order, layer by layer). ``rng`` a ``core.jax_prng`` key: the
    reference's tree and numbers — ``transformer.init_lm``'s key tree
    (``split(key, 4)`` into embed, prefix, stack and head; ``fold_in`` a
    prefix layer's index; ``split(k_stack, groups)``, then ``fold_in``
    the layer's index in its group) — as CPU tensors. ``rng="meta"``: the
    reference's tree on the meta device (shapes and dtypes only)."""
    _check_config(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    dev = rng_device(rng)
    specs = layer_specs(cfg)
    k_embed, k_prefix, k_stack, k_head = split_rng(rng, 4)
    params = {
        "embed": normal(k_embed, (cfg.vocab_size, cfg.d_model),
                        mul=0.02).to(dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(k_head, cfg.d_model, cfg.vocab_size,
                                        dtype)
    if isinstance(rng, torch.Generator):
        params["layers"] = [_init_layer(rng, cfg, spec, dtype)
                            for spec in specs]
        return params
    prefix, period, groups = stack_plan(cfg)
    params["prefix_layers"] = tuple(
        _init_layer(fold_rng(k_prefix, i), cfg, specs[i], dtype)
        for i in range(prefix))
    gkeys = split_rng(k_stack, groups)
    params["stack"] = _stack_trees([
        tuple(_init_layer(fold_rng(gkey, j), cfg, specs[prefix + j], dtype)
              for j in range(period)) for gkey in gkeys]) if groups else ()
    return params


def init_states(cfg, batch, capacity, dtype=None, device=None) -> List:
    """One empty cache of ``capacity`` slots per attention layer (GQA's
    K/V or MLA's latent); one zero SSM state ({"conv": (B, cw - 1, d_in)
    in dtype, "h": (B, d_in, N) f32}) per SSM layer, whatever the
    capacity."""
    _check_config(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    return [attn_mod.init_cache(cfg, batch, capacity, dtype, device)
            if kind == "attn" else
            ssm_mod.init_ssm_state(cfg, batch, dtype, device)
            for kind, _ in layer_specs(cfg)]


def _embed_inputs(cfg, params, tokens, embeds, tp=None):
    if embeds is not None and cfg.modality != "vision":
        raise ValueError(
            f"{cfg.name}: embeddings for modality {cfg.modality!r}: a "
            "decoder stack takes a VLM's patch embeddings only; audio "
            "frames go through the encoder, models/encdec.py")
    x = tpm.embed_lookup(params["embed"], tokens, tp, cfg.vocab_size)
    if embeds is not None:
        # VLM: the stubbed vision tower's pre-projected patch embeddings,
        # prepended to the text tokens (anyres tiles flattened)
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _remat(remat: str, fn):
    """``fn`` as it is ("none"), or under torch.utils.checkpoint
    (non-reentrant, "full"): only its inputs are kept, the rest is
    recomputed in the backward."""
    if remat == "none":
        return fn
    return lambda *args: torch_checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)


def lm_forward(cfg, params, tokens, positions=None, *, embeds=None,
               states: Optional[List] = None, window: int = 0,
               attn_impl: str = "auto", ssm_impl: str = "auto",
               logits_slice_last: bool = False, remat: str = "none",
               moe_groups: int = 1, moe_impl: str = "gshard",
               moe_mesh=None, shard_fn=None, tp=None, ep=None):
    """Returns (logits, new_states, aux_loss): the MoE layers' scaled aux
    losses summed in f32 (0 without MoE).

    tokens (B, S) int; embeds (B, P, D) patch embeddings of a VLM,
    prepended (positions then cover P + S). states from init_states:
    prefill fills them, decode (S = 1) steps them — the attention caches
    are written in place, the SSM states replaced, and all returned in a
    new list. ``attn_impl`` goes to every attention call, ``ssm_impl``
    ("auto" | "reference") to every SSM mixer. ``remat`` ("none" or
    "full", full-sequence forwards only) checkpoints each layer for the
    backward (``_remat``); it needs plain autograd, not torch.func.
    ``moe_groups`` token groups route each MoE layer (moe.moe_forward);
    ``moe_impl`` "gshard" (that dispatch) or "ep" (moe_ep.moe_forward_ep
    over ``moe_mesh``, launch/mesh.make_debug_mesh: ``tokens`` are this
    rank's rows of the batch — in a prefill or decode, ``states`` hold
    those rows alone —, the MoE layers run its experts; ``ep`` and
    ``tp`` the mesh's axes' contexts, found from the mesh when not
    given);
    ``shard_fn(tensor, role)`` is the reference's MoE placement hook
    (moe.moe_forward).

    ``tp`` (a sharding/tensor_parallel.TPContext; every family, with or
    without ``states``) runs this model rank's part of a Megatron
    tensor-parallel forward on the tree of sharding/layout.TPView: the
    embedding looked up vocab-parallel when it is split on V, each
    layer's attention and MLP on the rank's heads and d_ff slice with
    one all-reduce after ``wo`` and one after ``down`` (an MoE layer's
    after the combine, moe.py; MLA's heads after replicated latents,
    attention.mla_forward; a Mamba layer on the rank's d_inner channels,
    ssm.mamba_forward), and the logits of the rank's vocab slice when the
    head is split (the whole logits otherwise). The rest is
    replicated. Its states are the rank's (sharding/layout.TPView.
    serving_states: each attention cache the rank's KV heads, or MLA's
    whole latent; each SSM state the rank's channels)."""
    _check_config(cfg)
    _check_moe_impl(moe_impl)
    if moe_impl == "ep":
        ep, tp = _mesh_contexts(moe_mesh, ep, tp)
    if remat not in REMATS:
        raise ValueError(f"lm_forward: remat must be one of {REMATS}, got "
                         f"{remat!r}")
    if remat != "none" and states is not None:
        raise ValueError("lm_forward: remat is for full-sequence forwards; "
                         "a prefill or decode with states keeps none")
    x = _embed_inputs(cfg, params, tokens, embeds, tp)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    new_states = None if states is None else []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = {"window": window, "attn_impl": attn_impl, "ssm_impl": ssm_impl,
          "moe_groups": moe_groups, "shard_fn": shard_fn, "tp": tp,
          "moe_impl": moe_impl, "moe_mesh": moe_mesh, "ep": ep}
    for i, (spec, p) in enumerate(zip(layer_specs(cfg),
                                      layer_params(cfg, params))):
        if states is None:
            def layer(x, p=p, spec=spec):
                x, _, aux = _layer_forward(cfg, spec, p, x, positions, None,
                                           **kw)
                return (x,) if aux is None else (x, aux)
            x, *aux = _remat(remat, layer)(x)
        else:
            x, nst, aux = _layer_forward(cfg, spec, p, x, positions,
                                         states[i], **kw)
            new_states.append(nst)
            aux = [] if aux is None else [aux]
        for a in aux:
            aux_total = aux_total + a
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if logits_slice_last:
        x = x[:, -1:, :]
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
    if head.shape[-1] < cfg.vocab_size:
        x = tpm.copy_to_region(x, tp)      # the vocab-parallel head
    if cfg.tie_embeddings:
        logits = x @ head
    else:
        logits = linear(params["lm_head"], x)
    return logits, new_states, aux_total


def loss_fn(cfg, params, batch, *, attn_impl: str = "auto",
            ssm_impl: str = "auto", **fw_kw):
    """Causal-LM cross entropy (+ the MoE aux term): batch
    {"tokens": (B, S), "labels": (B, S)} with -100 = ignore; a VLM adds
    "patch_embeds" (B, P, D), whose logits are sliced off. Logits in f32;
    the mean over valid labels, ce.sum() / max(valid, 1).

    The training route (module docstring): "auto" attention is the
    reference's plain rule (``sdpa(impl="plain")``) and the "auto" mixer
    the plain scan, on every device. ``fw_kw`` go to ``lm_forward``
    (``remat`` under plain autograd only). With ``tp`` in them, logits
    split over the vocab give the vocab-parallel cross entropy
    (sharding/tensor_parallel.cross_entropy); the loss is the same on
    every model rank.

    With ``moe_impl="ep"`` the batch is this rank's rows over the mesh's
    data axis: the loss is the whole batch's (the valid labels counted
    over the data group, the rows' sums summed over it), the same on
    every rank, and its gradient this rank's share — summed over the
    data group it is the whole loss's (launch/steps.py)."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    embeds = batch.get("patch_embeds")
    ep = None
    if fw_kw.get("moe_impl") == "ep":
        ep, fw_kw["tp"] = _mesh_contexts(fw_kw.get("moe_mesh"),
                                         fw_kw.get("ep"), fw_kw.get("tp"))
        fw_kw["ep"] = ep
    logits, _, aux = lm_forward(
        cfg, params, tokens, embeds=embeds,
        attn_impl="plain" if attn_impl == "auto" else attn_impl,
        ssm_impl="reference" if ssm_impl == "auto" else ssm_impl, **fw_kw)
    if embeds is not None:
        # logits cover [patches + text]; labels only the text part
        logits = logits[:, embeds.shape[1]:, :]
    ce = tpm.cross_entropy(logits, labels, fw_kw.get("tp"), cfg.vocab_size)
    valid = (labels >= 0).sum()
    if ep is None:
        return ce.sum() / torch.clamp(valid, min=1) + aux
    valid = ep._collective("ep_all_reduce", valid, dist.ReduceOp.SUM)
    return tpm.reduce_from_region(ce.sum() / torch.clamp(valid, min=1), ep,
                                  "ep_all_reduce") + aux


class LMLoss:
    """A decoder's causal-LM task loss, ``loss(params, batch)`` =
    ``loss_fn(cfg, params, batch, **kw)``, and its tensor-parallel form
    ``loss(params, batch, tp=ctx)`` on a sharding/layout.TPView tree of
    ``cfg``'s params. ``tensor_parallel`` says that the task trains so:
    every family the port builds has a Megatron form (a model axis that
    does not divide MLA's heads, the MLP width or d_inner raises in
    sharding/layout.tp_classes, naming the leaf; a GQA attention whose
    heads it does not divide runs whole on every rank). A trainer or round step
    on a (clients, model) mesh picks its route from it once, when it is
    built (core/round.py)."""

    tensor_parallel = True

    def __init__(self, cfg, **kw):
        self.cfg, self.kw = cfg, kw

    def __call__(self, params, batch, tp=None):
        return loss_fn(self.cfg, params, batch, tp=tp, **self.kw)
