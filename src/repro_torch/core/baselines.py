"""FL server rules the paper compares against (counterpart of
repro/core/baselines.py; paper §3, §5.2.3):

  fedavg   plain mean of local updates (two-sided LRs)
  fedprox  fedavg server; clients add a proximal term (client variant)
  fedexp   extrapolated server LR from the POCS view (Jhunjhunwala et al.)
  fedga    fedavg server; clients start displaced along Δ_{t-1}
  fedcm    fedavg server; clients mix Δ_{t-1} into every local gradient
  fedvarp  server keeps the latest update of EVERY client and uses
           surrogate updates for absent ones (stateful, O(num_clients N))
  feddpc   the paper's method (core/feddpc.py)
  feddpc_noscale  ablation: projection only (Fig. 6)
  fedadam / fedyogi  the client mean feeds a server-side adaptive step
  feddpc_m FedDPC plus server momentum on its aggregate

Unified interface so the trainer can swap algorithms:

  algo.init(params, num_clients)                         -> server_state
  algo.step(state, params, deltas, client_ids, eta_g, t,
            client_mask=None, edges=None, shard=None)
                                                -> (params', state', diag)
  algo.client_variant in {"plain","prox","cm","ga"}      local-training flavour
  algo.client_extra(state)    what clients get from the server (Δ_{t-1})
  algo.client_hparams         kwargs the local update needs
                              (mu / cm_alpha / ga_beta for its variant)

A ``staleness_aware`` rule (the FedDPC family) also takes the buffered-
async ``staleness_weights`` and folds them into its own scalars; for any
other rule the trainer pre-scales the buffered deltas by the weights
(FedBuff mean semantics). FedDPC's step also takes the codec payload
(``encoded``, ``leaf_offsets``) for its dequant folds. Steps accept
unknown kwargs (**_).

``edges=E`` aggregates in two levels, as the reference's rules do: each
of E equal contiguous row groups reduces to a partial summary and the
server combines the E summaries (FedExP's Σ‖Δ_j‖² as a sum of edge sums,
FedVARP's correction mean and the FedDPC family's fold included). In a
multi-process round ``shard`` (core/round.RankShard) gives this rank's
rows: ``deltas`` hold them, while ``client_ids`` and ``client_mask``
cover the whole padded cohort, so every rank forms the same scalars; the
means sum their partials over the ranks (``shard.all_sum``), FedVARP
gathers the cohort's rows (its table is replicated state), and the rules
whose ``row_scalars`` are "dots" (the FedDPC family) or "sqnorm"
(FedExP) read the gathered per-row scalars from ``shard.dots``. On the
model axis (``shard.model > 1``) params, deltas and every state vector
are the rank's shards of N_m columns (FedVARP's table (num_clients,
N_m), its leading dim whole); the rules are element-wise there, and
their norms are model-summed (``projection.global_norm``).

params and every state vector are flat (N,) f32 buffers
(repro_torch.bridge); deltas are the (K, N) client stack, client_ids
(K,) int. ``client_mask`` (K,) bool marks the rows that count: masked
rows carry ``round.ID_SENTINEL`` ids (deadline, guard), and neither
move a mean, FedExP's count nor FedVARP's table.

The FedDPC family's arithmetic goes through the FedDPC kernels
(core/feddpc.py); the other rules' means and moments are plain torch, as
the reference leaves them to XLA.

Algorithms register through ``register_algorithm(name, HyperCls)``, and
``make_algorithm(name, hyper)`` builds the ``ServerAlgo`` from the
registry with a hyper dataclass instance, a kwargs dict, or None.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import feddpc as feddpc_mod
from repro_torch.core import projection as proj


@dataclass(frozen=True)
class ServerAlgo:
    name: str
    init: Callable[[torch.Tensor, int], Dict[str, torch.Tensor]]
    step: Callable[..., Tuple[torch.Tensor, Dict, Dict]]
    client_variant: str = "plain"
    # what local training needs from server state (None if nothing)
    client_extra: Callable[[Dict], Optional[torch.Tensor]] = \
        lambda s: None
    stateful_per_client: bool = False
    # per-variant local-training knobs (mu / cm_alpha / ga_beta) from the
    # algorithm's hyper dataclass
    client_hparams: Dict[str, float] = field(default_factory=dict)
    hyper: Any = None
    staleness_aware: bool = False
    # per-row scalars the step reads in a multi-process round, gathered
    # by the round into shard.dots: "dots" (<Δ_j,Δ_prev>, ||Δ_j||²,
    # ||Δ_prev||²), "sqnorm" (||Δ_j||² only) or None
    row_scalars: Optional[str] = None


def _apply(params: torch.Tensor, delta: torch.Tensor, eta_g
           ) -> torch.Tensor:
    return (params.float() - eta_g * delta.float()).to(params.dtype)


# ---------------- registry ----------------

@dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    hyper_cls: Type
    build: Callable[[Any], ServerAlgo]


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def register_algorithm(name: str, hyper_cls: Type = None):
    """Decorator: ``@register_algorithm("myalgo", MyHyper)`` over a
    ``build(hyper) -> ServerAlgo`` factory adds it to the registry."""
    def deco(build):
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered")
        _REGISTRY[name] = AlgorithmSpec(name, hyper_cls or NoHyper, build)
        return build
    return deco


def make_algorithm(name: str, hyper=None) -> ServerAlgo:
    try:
        spec = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; registered: "
                         f"{', '.join(sorted(_REGISTRY))}") from None
    if hyper is None:
        hyper = spec.hyper_cls()
    elif isinstance(hyper, dict):
        hyper = spec.hyper_cls(**hyper)
    elif not isinstance(hyper, spec.hyper_cls):
        raise TypeError(f"{name} expects {spec.hyper_cls.__name__} hyper-"
                        f"parameters, got {type(hyper).__name__}")
    return dataclasses.replace(spec.build(hyper), hyper=hyper)


def algorithm_hyper_cls(name: str) -> Type:
    return _REGISTRY[name].hyper_cls


def default_hyper(name: str, *, lam: float = 1.0, mu: float = 0.01,
                  cm_alpha: float = 0.1, ga_beta: float = 0.1):
    """Hyper instance built from the flat CLI knobs; None for algorithms
    none of them reach (registry defaults apply)."""
    return {
        "feddpc": lambda: FedDPCHyper(lam=lam),
        "feddpc_m": lambda: FedDPCMHyper(lam=lam),
        "fedprox": lambda: FedProxHyper(mu=mu),
        "fedcm": lambda: FedCMHyper(alpha=cm_alpha),
        "fedga": lambda: FedGAHyper(beta=ga_beta),
    }.get(name, lambda: None)()


def client_kwargs(algo: ServerAlgo) -> Dict[str, float]:
    """Local-update kwargs the algorithm pins (its variant-specific
    hypers); knobs it leaves unset keep core/client.py's defaults."""
    return dict(algo.client_hparams)


# ---------------- hyperparameter dataclasses ----------------

@dataclass(frozen=True)
class NoHyper:
    pass


@dataclass(frozen=True)
class FedProxHyper:
    mu: float = 0.01                 # proximal strength


@dataclass(frozen=True)
class FedCMHyper:
    alpha: float = 0.1               # client-momentum mixing


@dataclass(frozen=True)
class FedGAHyper:
    beta: float = 0.1                # displacement along Delta_{t-1}


@dataclass(frozen=True)
class FedExPHyper:
    eps: float = 1e-3                # extrapolation denominator guard


@dataclass(frozen=True)
class FedDPCHyper:
    lam: float = 1.0                 # adaptive-scaling hyper-param


@dataclass(frozen=True)
class FedDPCMHyper:
    lam: float = 1.0
    beta: float = 0.9                # server momentum


@dataclass(frozen=True)
class AdaptiveHyper:                 # FedAdam / FedYogi (Reddi et al.)
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3


def _init(params, num_clients):
    return feddpc_mod.init_state(params)     # {"delta_prev": zeros}


def _delta_prev(state):
    return state["delta_prev"]


# ---------------- FedAvg family ----------------

def _fedavg_step(state, params, deltas, client_ids, eta_g, t,
                 client_mask=None, edges=None, shard=None, **_):
    delta_t = proj.masked_client_mean(deltas, client_mask, edges=edges,
                                      shard=shard)
    return _apply(params, delta_t, eta_g), {"delta_prev": delta_t}, {
        "norm_global_update": proj.global_norm(delta_t, shard)}


@register_algorithm("fedavg")
def _build_fedavg(h):
    return ServerAlgo("fedavg", _init, _fedavg_step)


@register_algorithm("fedprox", FedProxHyper)
def _build_fedprox(h):
    # same server as FedAvg; the prox term is applied in the client loop
    return ServerAlgo("fedprox", _init, _fedavg_step,
                      client_variant="prox", client_hparams={"mu": h.mu})


# ---------------- FedExP ----------------

def _fedexp_step(state, params, deltas, client_ids, eta_g, t, eps=1e-3,
                 client_mask=None, edges=None, shard=None, **_):
    """eta_g_t = max(1, sum_j||Δ_j||² / (2 k' (||Δ̄||² + eps))) — the POCS
    extrapolation rule; then w ← w − eta_g · eta_g_t · Δ̄. Under edges
    the sum is the sum of the E edge sums."""
    delta_t = proj.masked_client_mean(deltas, client_mask, edges=edges,
                                      shard=shard)
    sq_each = (proj.tree_sqnorm(deltas) if shard is None
               else shard.dots[:, 1])                          # (K,)
    if client_mask is None:
        kprime = sq_each.shape[0]
    else:
        mf = client_mask.float()
        sq_each = sq_each * mf
        kprime = torch.clamp(mf.sum(), min=1.0)
    sq_mean = proj.model_summed(proj.tree_sqnorm(delta_t), shard)
    sq_total = (sq_each.reshape(int(edges), -1).sum(dim=1).sum()
                if edges and edges > 1 else sq_each.sum())
    extrap = torch.clamp(sq_total / (2 * kprime * (sq_mean + eps)),
                         min=1.0)
    return _apply(params, delta_t, eta_g * extrap), {
        "delta_prev": delta_t}, {
        "norm_global_update": torch.sqrt(sq_mean), "extrap": extrap}


@register_algorithm("fedexp", FedExPHyper)
def _build_fedexp(h):
    return ServerAlgo("fedexp", _init,
                      functools.partial(_fedexp_step, eps=h.eps),
                      row_scalars="sqnorm")


# ---------------- FedGA / FedCM ----------------

@register_algorithm("fedga", FedGAHyper)
def _build_fedga(h):
    return ServerAlgo("fedga", _init, _fedavg_step, client_variant="ga",
                      client_extra=_delta_prev,
                      client_hparams={"ga_beta": h.beta})


@register_algorithm("fedcm", FedCMHyper)
def _build_fedcm(h):
    return ServerAlgo("fedcm", _init, _fedavg_step, client_variant="cm",
                      client_extra=_delta_prev,
                      client_hparams={"cm_alpha": h.alpha})


# ---------------- FedVARP ----------------

def _fedvarp_init(params, num_clients):
    return {"y": torch.zeros((num_clients, params.shape[0]),
                             dtype=torch.float32, device=params.device),
            "delta_prev": torch.zeros_like(params, dtype=torch.float32)}


def _fedvarp_step(state, params, deltas, client_ids, eta_g, t,
                  client_mask=None, edges=None, shard=None, **_):
    """Δ_t = (1/n)Σ_i y_i + (1/k')Σ_{j∈S}(Δ_j − y_j);  y_j ← Δ_j for j∈S.

    A row counts when its id is in [0, num_clients) and its mask bit is
    set; the others (``ID_SENTINEL`` from the deadline or the guard)
    gather zeros and leave the table untouched. The table is updated IN
    PLACE (``index_copy_`` of the counted rows): the returned state holds
    the same (num_clients, N) tensor, so it is never double-buffered.
    The correction mean goes two-level under ``edges``; in a
    multi-process round the rank gathers the cohort's rows first, so
    every rank updates its replica of the table alike."""
    if shard is not None:
        deltas = shard.gather(deltas)
    y = state["y"]
    ids = client_ids.to(device=y.device, dtype=torch.int64)
    valid = (ids >= 0) & (ids < y.shape[0])
    if client_mask is not None:
        valid = valid & client_mask.to(y.device)
    y_sel = y.index_select(0, torch.where(valid, ids, torch.zeros_like(ids)))
    y_sel.masked_fill_(~valid[:, None], 0.0)
    corr = proj.masked_client_mean(deltas.float() - y_sel, client_mask,
                                   edges=edges)
    delta_t = y.mean(dim=0) + corr
    keep = torch.nonzero(valid).squeeze(1)
    y.index_copy_(0, ids[keep], deltas.float()[keep])
    return _apply(params, delta_t, eta_g), {
        "y": y, "delta_prev": delta_t}, {
        "norm_global_update": proj.global_norm(delta_t, shard)}


@register_algorithm("fedvarp")
def _build_fedvarp(h):
    return ServerAlgo("fedvarp", _fedvarp_init, _fedvarp_step,
                      stateful_per_client=True)


# ---------------- FedDPC (the paper) ----------------

@register_algorithm("feddpc", FedDPCHyper)
def _build_feddpc(h):
    def step(state, params, deltas, client_ids, eta_g, t,
             client_mask=None, staleness_weights=None, encoded=None,
             leaf_offsets=None, edges=None, shard=None, **_):
        return feddpc_mod.server_step(
            state, params, deltas, eta_g, h.lam, client_mask=client_mask,
            staleness_weights=staleness_weights, encoded=encoded,
            leaf_offsets=leaf_offsets, edges=edges, shard=shard)

    return ServerAlgo("feddpc", _init, step, staleness_aware=True,
                      row_scalars="dots")


def _feddpc_noscale_step(state, params, deltas, client_ids, eta_g, t,
                         client_mask=None, edges=None, shard=None, **_):
    return feddpc_mod.server_step_projection_only(
        state, params, deltas, eta_g, client_mask=client_mask, edges=edges,
        shard=shard)


@register_algorithm("feddpc_noscale")
def _build_feddpc_noscale(h):
    return ServerAlgo("feddpc_noscale", _init, _feddpc_noscale_step,
                      row_scalars="dots")


# ---------------- adaptive server optimizers (Reddi et al.) ----------

def _adaptive_init(params, num_clients):
    z = torch.zeros(params.shape, dtype=torch.float32, device=params.device)
    return {"delta_prev": z, "m": z.clone(), "v": z.clone(),
            "t": torch.zeros((), dtype=torch.float32, device=params.device)}


def _make_adaptive(kind: str, h: AdaptiveHyper) -> ServerAlgo:
    """FedAdam / FedYogi: the client-mean pseudo-gradient feeds a server-
    side adaptive optimizer."""
    b1, b2, eps = h.b1, h.b2, h.eps

    def step(state, params, deltas, client_ids, eta_g, t_unused,
             client_mask=None, edges=None, shard=None, **_):
        delta_t = proj.masked_client_mean(deltas, client_mask, edges=edges,
                                          shard=shard)
        t = state["t"] + 1.0
        m = b1 * state["m"] + (1 - b1) * delta_t
        if kind == "adam":
            v = b2 * state["v"] + (1 - b2) * delta_t * delta_t
        else:   # yogi
            v = state["v"] - (1 - b2) * delta_t * delta_t * torch.sign(
                state["v"] - delta_t * delta_t)
        upd = m / (torch.sqrt(v) + eps)
        return _apply(params, upd, eta_g), {
            "delta_prev": delta_t, "m": m, "v": v, "t": t}, {
            "norm_global_update": proj.global_norm(upd, shard)}

    return ServerAlgo(f"fed{kind}", _adaptive_init, step)


@register_algorithm("fedadam", AdaptiveHyper)
def _build_fedadam(h):
    return _make_adaptive("adam", h)


@register_algorithm("fedyogi", AdaptiveHyper)
def _build_fedyogi(h):
    return _make_adaptive("yogi", h)


# ---------------- FedDPC-M ----------------

@register_algorithm("feddpc_m", FedDPCMHyper)
def _build_feddpc_m(h):
    """FedDPC + server momentum on the aggregated (projected + scaled)
    update: m_t = beta m_{t-1} + Δ_t; w -= eta_g m_t. ``server_step``
    runs with eta_g = 0 and only its Δ_t is kept, so the step goes
    through the FedDPC kernels (the batched epilogue in sync rounds, the
    buffer fold in async ones); the projection is against the raw
    previous Δ."""
    lam, beta = h.lam, h.beta

    def init(params, num_clients):
        s = feddpc_mod.init_state(params)
        s["m"] = torch.zeros_like(params, dtype=torch.float32)
        return s

    def step(state, params, deltas, client_ids, eta_g, t,
             client_mask=None, staleness_weights=None, edges=None,
             shard=None, **_):
        _, new_state, diag = feddpc_mod.server_step(
            {"delta_prev": state["delta_prev"]}, params, deltas, 0.0, lam,
            client_mask=client_mask, staleness_weights=staleness_weights,
            edges=edges, shard=shard)
        delta_t = new_state["delta_prev"]
        m = beta * state["m"] + delta_t
        return _apply(params, m, eta_g), {"delta_prev": delta_t,
                                          "m": m}, diag

    return ServerAlgo("feddpc_m", init, step, staleness_aware=True,
                      row_scalars="dots")


# ---------------- legacy shim ----------------

FEDAVG = make_algorithm("fedavg")
FEDPROX = make_algorithm("fedprox")
FEDEXP = make_algorithm("fedexp")
FEDGA = make_algorithm("fedga")
FEDCM = make_algorithm("fedcm")
FEDVARP = make_algorithm("fedvarp")
FEDDPC = make_algorithm("feddpc")
FEDDPC_NOSCALE = make_algorithm("feddpc_noscale")
FEDADAM = make_algorithm("fedadam")
FEDYOGI = make_algorithm("fedyogi")
FEDDPC_M = make_algorithm("feddpc_m")


def get_algorithm(name: str, *, lam: float = 1.0) -> ServerAlgo:
    """DEPRECATED: the flat ``lam`` kwarg only parameterizes the feddpc
    family. Use ``make_algorithm(name, hyper)`` with the algorithm's
    hyper dataclass instead."""
    warnings.warn(
        "get_algorithm(name, lam=...) is deprecated; use "
        "make_algorithm(name, hyper) with the per-algorithm hyper "
        "dataclass (e.g. FedDPCHyper)", DeprecationWarning, stacklevel=2)
    return make_algorithm(name, default_hyper(name, lam=lam))


ALGORITHM_NAMES = tuple(_REGISTRY)
