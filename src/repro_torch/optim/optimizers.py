"""Local optimizers with the reference's ``Optimizer(init, update)`` shape
(counterpart of repro/optim/optimizers.py); this slice carries SGD.

update(grads, state, params, step) -> (updates, new_state); the caller
SUBTRACTS the updates (w <- w - eta * g, the paper's convention). Tensors
here are flat parameter buffers, (N,) or a (K, N) client stack.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, torch.Tensor, int],
                     Tuple[torch.Tensor, Any]]


def sgd(learning_rate: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        return learning_rate * grads, state

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name != "sgd":
        raise ValueError(f"unknown optimizer {name!r}; this port has "
                         "'sgd'")
    return sgd(lr)
