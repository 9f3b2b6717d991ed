"""Client-side local training (paper Algorithm 1, lines 4-13); counterpart
of repro/core/client.py, plain variant (the prox/cm/ga variants of the
other server rules come with them).

A client runs its local optimizer over a fixed-shape stack of M
minibatches with a validity mask (clients with fewer batches pad with
masked ones, which are no-ops) and returns the pseudo-gradient

    Delta_j = (w_{t-1} - w_j) / eta_l                    (line 12)

and its mean loss over the valid batches.

Parameters are flat f32 buffers (repro_torch.bridge): the model sees
per-leaf views of them, and autograd returns the gradient as one flat
vector. ``make_cohort_local_update`` runs K clients at once — their
params a (K, N) stack, the per-step gradient ``torch.func.vmap`` of the
one-client gradient, as the reference vmaps its scan over clients.
``make_local_update`` is the one-client form it is held against.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.bridge import FlatLayout, tree_leaves, tree_map
from repro_torch.optim.optimizers import get_optimizer


def _build_local_update(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                        optimizer: str, cohort: bool):
    opt = get_optimizer(optimizer, eta_l)
    step_grad = grad_and_value(
        lambda w, batch: loss_fn(layout.unflatten(w), batch))
    if cohort:
        step_grad = vmap(step_grad)

    def local_update(global_params: torch.Tensor, batches,
                     mask: Optional[torch.Tensor],
                     out: Optional[torch.Tensor] = None):
        """global_params (N,); batches a tree with leading (K, M) axes
        (cohort) or (M,) (one client); mask (K, M) / (M,) bool, or None
        for all valid. Returns (delta, mean_loss): (K, N) and (K,) for a
        cohort — written into ``out`` when given — or (N,) and ()."""
        leaf = tree_leaves(batches)[0]
        lead = tuple(leaf.shape[:1]) if cohort else ()
        m = leaf.shape[len(lead)]
        w = global_params.expand(*lead, -1).clone()
        opt_state = opt.init(w)
        loss_sum = torch.zeros(lead, device=w.device)
        nvalid = torch.zeros(lead, device=w.device)
        for i in range(m):
            batch = tree_map(lambda x: x[:, i] if cohort else x[i], batches)
            grads, loss = step_grad(w, batch)
            updates, new_opt_state = opt.update(grads, opt_state, w, i)
            new_w = w - updates
            if mask is None:
                w, opt_state = new_w, new_opt_state
                loss_sum = loss_sum + loss
                nvalid = nvalid + 1.0
            else:
                # masked batches are no-ops
                valid = mask[..., i]
                keep = valid[..., None]
                w = torch.where(keep, new_w, w)
                opt_state = tree_map(lambda a, b: torch.where(keep, a, b),
                                     new_opt_state, opt_state)
                loss_sum = loss_sum + torch.where(valid, loss,
                                                  torch.zeros_like(loss))
                nvalid = nvalid + valid.float()
        delta = torch.sub(global_params, w, out=out)
        delta.div_(eta_l)
        return delta, loss_sum / torch.clamp(nvalid, min=1.0)

    return local_update


def make_local_update(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                      optimizer: str = "sgd"):
    """fn(global_params (N,), batches (M, ...), mask (M,) or None,
    out=None) -> (delta (N,), mean_loss ())."""
    return _build_local_update(loss_fn, layout, eta_l, optimizer,
                               cohort=False)


def make_cohort_local_update(loss_fn: Callable, layout: FlatLayout,
                             eta_l: float, optimizer: str = "sgd"):
    """fn(global_params (N,), batches (K, M, ...), masks (K, M) or None,
    out=None) -> (deltas (K, N), losses (K,)); params broadcast to every
    client."""
    return _build_local_update(loss_fn, layout, eta_l, optimizer,
                               cohort=True)
