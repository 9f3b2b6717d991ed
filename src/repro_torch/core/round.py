"""One FL round over a cohort: K local trainings, then the server rule;
counterpart of repro/core/round.py ``make_cohort_round`` (without
faults, guard, codec, mesh, server optimizer or edges in this slice).

The K clients' deltas land in one (K, N) f32 stack — the layout the
FedDPC kernels read. The stack is allocated once and reused for every
round with the same K (its shape does not depend on the minibatch
bucket M); the reference gets the same effect by donating its buffers
to the jit'd round.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.bridge import FlatLayout, tree_leaves
from repro_torch.core import client as client_mod
from repro_torch.core.baselines import ServerAlgo


def make_cohort_round(loss_fn: Callable, layout: FlatLayout,
                      algo: ServerAlgo, eta_l: float, eta_g: float, *,
                      optimizer: str = "sgd"):
    """Returns cohort_round(server_state, params, batches, masks,
    client_ids) -> (new_params, new_server_state, losses (K,), diag).

    batches: a tree with leading axes (K, M, ...) on the params' device;
    masks (K, M) bool marks the valid minibatches (None = all valid)."""
    local = client_mod.make_cohort_local_update(loss_fn, layout, eta_l,
                                                optimizer=optimizer)
    stack: Optional[torch.Tensor] = None

    def cohort_round(server_state, params: torch.Tensor, batches,
                     masks: Optional[torch.Tensor], client_ids):
        nonlocal stack
        k = tree_leaves(batches)[0].shape[0]
        if stack is None or stack.shape[0] != k or \
                stack.device != params.device:
            stack = torch.empty((k, params.shape[0]), dtype=torch.float32,
                                device=params.device)
        deltas, losses = local(params, batches, masks, out=stack)
        new_params, new_state, diag = algo.step(
            server_state, params, deltas, client_ids, eta_g, 0)
        return new_params, new_state, losses, diag

    return cohort_round
