"""Server rules behind one interface (counterpart of
repro/core/baselines.py); this slice carries FedDPC and FedAvg, the
paper's method and its control.

  algo.init(params, num_clients)                         -> server_state
  algo.step(state, params, deltas, client_ids, eta_g, t,
            client_mask=None) -> (params', state', diag)

A ``staleness_aware`` rule (FedDPC) also takes the buffered-async
``staleness_weights`` and folds them into its own scalars; for any other
rule the trainer pre-scales the buffered deltas by the weights (FedBuff
mean semantics). FedDPC's step also takes the codec payload
(``encoded``, ``leaf_offsets``) for its dequant folds.

params and every state vector are flat (N,) f32 buffers
(repro_torch.bridge); deltas are the (K, N) client stack.

Algorithms register through ``register_algorithm(name, HyperCls)``, and
``make_algorithm(name, hyper)`` builds the ``ServerAlgo`` from the
registry with a hyper dataclass instance, a kwargs dict, or None.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Type

import torch

from repro_torch.core import feddpc as feddpc_mod
from repro_torch.core import projection as proj


@dataclass(frozen=True)
class ServerAlgo:
    name: str
    init: Callable[[torch.Tensor, int], Dict[str, torch.Tensor]]
    step: Callable[..., Tuple[torch.Tensor, Dict, Dict]]
    hyper: Any = None
    staleness_aware: bool = False


@dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    hyper_cls: Type
    build: Callable[[Any], ServerAlgo]


_REGISTRY: Dict[str, AlgorithmSpec] = {}


@dataclass(frozen=True)
class NoHyper:
    pass


@dataclass(frozen=True)
class FedDPCHyper:
    lam: float = 1.0                 # adaptive-scaling hyper-param


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


def default_hyper(name: str, *, lam: float = 1.0):
    """Hyper instance from the flat CLI knobs; None where none applies."""
    return FedDPCHyper(lam=lam) if name == "feddpc" else None


def _init(params, num_clients):
    return feddpc_mod.init_state(params)     # {"delta_prev": zeros}


# ---------------- FedAvg ----------------

def _fedavg_step(state, params, deltas, client_ids, eta_g, t,
                 client_mask=None, **_):
    # plain torch: the reference leaves the mean and update to XLA too
    delta_t = proj.masked_client_mean(deltas, client_mask)
    new_params = (params.float() - eta_g * delta_t).to(params.dtype)
    return new_params, {"delta_prev": delta_t}, {
        "norm_global_update": proj.tree_norm(delta_t)}


@register_algorithm("fedavg")
def _build_fedavg(h):
    return ServerAlgo("fedavg", _init, _fedavg_step)


# ---------------- FedDPC ----------------

@register_algorithm("feddpc", FedDPCHyper)
def _build_feddpc(h):
    def step(state, params, deltas, client_ids, eta_g, t,
             client_mask=None, staleness_weights=None, encoded=None,
             leaf_offsets=None, **_):
        return feddpc_mod.server_step(
            state, params, deltas, eta_g, h.lam, client_mask=client_mask,
            staleness_weights=staleness_weights, encoded=encoded,
            leaf_offsets=leaf_offsets)

    return ServerAlgo("feddpc", _init, step, staleness_aware=True)


ALGORITHM_NAMES = tuple(_REGISTRY)
