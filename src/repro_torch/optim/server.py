"""Server-side optimizers (counterpart of repro/optim/server.py): a
``ServerOptimizer`` consumes the POST-projection aggregate — the new
params every server rule proposes — so one implementation composes with
ANY registered rule, in the vectorized, serial and buffered-async rounds
alike (FedDPC's reduction-pass scalars are still computed from the raw
deltas before the optimizer sees the result).

The optimizer's view of a round is the pseudo-gradient

    g_t = params_t - proposed_{t+1}        (f32)

i.e. the descent direction the rule's step applied (its eta_g included).
``sgd`` accepts the proposal verbatim: it is stateless, and the trainer
keeps it out of the round entirely (``make_server_optimizer`` returns
None for it). ``fedadam`` / ``fedyogi`` re-step from params_t with
moment-preconditioned magnitudes (Reddi et al.):

    m = b1 m + (1-b1) g
    v = b2 v + (1-b2) g^2                      (adam)
    v = v - (1-b2) g^2 sign(v - g^2)           (yogi)
    params_{t+1} = params_t - lr * m / (sqrt(v) + eps)

State is ``{"m", "v"}``, flat (N,) f32 mirrors of the params.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ServerOptimizer:
    """``init(params) -> state``; ``apply(params, proposed, state) ->
    (new_params, new_state)``. ``stateful=False`` marks the literal
    pass-through the trainer keeps out of the round."""
    name: str
    init: Callable[[torch.Tensor], Any]
    apply: Callable[[torch.Tensor, torch.Tensor, Any],
                    Tuple[torch.Tensor, Any]]
    stateful: bool = True

    def config_dict(self) -> Dict[str, Any]:
        return {"name": self.name}


def _sgd() -> ServerOptimizer:
    def init(params):
        return None

    def apply(params, proposed, state):
        return proposed, state

    return ServerOptimizer("sgd", init, apply, stateful=False)


def _moment_init(params):
    z = torch.zeros(params.shape, dtype=torch.float32, device=params.device)
    return {"m": z, "v": z.clone()}


def _make_adaptive(kind: str, lr: float = 0.1, b1: float = 0.9,
                   b2: float = 0.99, eps: float = 1e-3) -> ServerOptimizer:
    def apply(params, proposed, state):
        g = params.float() - proposed.float()
        m = b1 * state["m"] + (1 - b1) * g
        if kind == "adam":
            v = b2 * state["v"] + (1 - b2) * g * g
        else:   # yogi
            v = state["v"] - (1 - b2) * g * g * torch.sign(state["v"]
                                                           - g * g)
        new = (params.float() - lr * m / (torch.sqrt(v) + eps)
               ).to(params.dtype)
        return new, {"m": m, "v": v}

    return ServerOptimizer(f"fed{kind}", _moment_init, apply)


_REGISTRY: Dict[str, Callable[[], ServerOptimizer]] = {
    "sgd": _sgd,
    "fedadam": lambda: _make_adaptive("adam"),
    "fedyogi": lambda: _make_adaptive("yogi"),
}

SERVER_OPTIMIZER_NAMES = tuple(_REGISTRY)


def make_server_optimizer(name: Optional[str]
                          ) -> Optional[ServerOptimizer]:
    """Resolve a registry name; ``None`` and ``"sgd"`` both yield None —
    the trainer treats "no optimizer object" as the pass-through, adding
    nothing to the round."""
    if name is None:
        return None
    if name not in _REGISTRY:
        raise ValueError(f"unknown server optimizer {name!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    opt = _REGISTRY[name]()
    return opt if opt.stateful else None
