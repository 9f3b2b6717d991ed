"""Local optimizers with the reference's ``Optimizer(init, update)`` shape
(counterpart of repro/optim/optimizers.py): SGD, momentum and AdamW, plus
the cosine and constant learning-rate schedules.

update(grads, state, params, step) -> (updates, new_state); the caller
SUBTRACTS the updates (w <- w - eta * g, the paper's convention). Tensors
here are flat parameter buffers, (N,) or a (K, N) client stack; ``step``
is the local step's index, a Python int (masked batches count too, as
the reference's scan counter does).
"""
from __future__ import annotations

import math
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


def momentum(learning_rate: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return torch.zeros_like(params)

    def update(grads, state, params, step):
        new_m = beta * state + grads
        return learning_rate * new_m, new_m

    return Optimizer(init, update)


def adamw(learning_rate: float, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.0) -> Optimizer:
    def init(params):
        z = torch.zeros(params.shape, dtype=torch.float32,
                        device=params.device)
        return {"m": z, "v": z.clone()}

    def update(grads, state, params, step):
        # the bias correction in f32, as the reference's
        # ``b1 ** (step.astype(f32) + 1)``
        f32 = dict(dtype=torch.float32, device=grads.device)
        t = torch.tensor(step, **f32) + 1.0
        c1 = 1 - torch.pow(torch.tensor(b1, **f32), t)
        c2 = 1 - torch.pow(torch.tensor(b2, **f32), t)
        g = grads.float()
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * torch.square(g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * params.float()
        return (learning_rate * u).to(params.dtype), {"m": m, "v": v}

    return Optimizer(init, update)


_OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw}


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; registered: "
                         f"{', '.join(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](lr, **kw)


# ---------------- schedules ----------------

def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) -> 0-d f32 tensor: linear warm-up over ``warmup`` steps,
    then a half cosine from base_lr to 0 at ``total``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
