"""Client-side local training (paper Algorithm 1, lines 4-13); counterpart
of repro/core/client.py.

A client runs its local optimizer over a fixed-shape stack of M
minibatches with a validity mask (clients with fewer batches pad with
masked ones, which are no-ops) and returns the pseudo-gradient

    Delta_j = (w_{t-1} - w_j) / eta_l                    (line 12)

and its mean loss over the valid batches.

Parameters are flat f32 buffers (repro_torch.bridge): the model sees
per-leaf views of them, and autograd returns the gradient as one flat
vector. The ``layout`` is anything with ``unflatten``: on the model
axis's tensor-parallel route, sharding/layout.TPView, so a cohort
trains (K, N_m) working copies of the rank's shard with the loss's
collectives inside; the optimizers are elementwise, and Δ_{t-1} is the
rank's shard too. ``make_cohort_local_update`` runs K clients at once — their
params a (K, N) stack, the per-step gradient ``torch.func.vmap`` of the
one-client gradient, as the reference vmaps its scan over clients.
``make_local_update`` is the one-client form it is held against.

Client variants (selected by the server algorithm; ``extra`` is the
server's Δ_{t-1}, broadcast to every client):
  plain  SGD/momentum/AdamW on the local loss
  prox   FedProx: + mu (w - w_global) added to every local gradient
  cm     FedCM:   g <- alpha g + (1 - alpha) Δ_{t-1}  (client momentum)
  ga     FedGA:   local model initialized at w - beta eta_l Δ_{t-1}; the
         returned Δ_j is still taken against the GLOBAL params
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.bridge import FlatLayout, tree_leaves, tree_map
from repro_torch.optim.optimizers import get_optimizer


VARIANTS = ("plain", "prox", "cm", "ga")


def _build_local_update(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                        optimizer: str, cohort: bool, variant: str,
                        mu: float, cm_alpha: float, ga_beta: float):
    if variant not in VARIANTS:
        raise ValueError(f"unknown client variant {variant!r}; one of "
                         f"{VARIANTS}")
    opt = get_optimizer(optimizer, eta_l)
    step_grad = grad_and_value(
        lambda w, batch: loss_fn(layout.unflatten(w), batch))
    if cohort:
        step_grad = vmap(step_grad)

    def local_update(global_params: torch.Tensor, batches,
                     mask: Optional[torch.Tensor],
                     extra: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None):
        """global_params (N,); batches a tree with leading (K, M) axes
        (cohort) or (M,) (one client); mask (K, M) / (M,) bool, or None
        for all valid; extra the (N,) Δ_{t-1} of the cm/ga variants (or
        None). Returns (delta, mean_loss): (K, N) and (K,) for a cohort
        — written into ``out`` when given, else into the working copies'
        own buffer — or (N,) and ()."""
        leaf = tree_leaves(batches)[0]
        lead = tuple(leaf.shape[:1]) if cohort else ()
        m = leaf.shape[len(lead)]
        w0 = global_params
        if variant == "ga" and extra is not None:
            # displacement init along the previous global direction
            w0 = (global_params.float()
                  - ga_beta * eta_l * extra.float()).to(global_params.dtype)
        w = w0.expand(*lead, -1).clone()
        opt_state = opt.init(w)
        loss_sum = torch.zeros(lead, device=w.device)
        nvalid = torch.zeros(lead, device=w.device)
        for i in range(m):
            batch = tree_map(lambda x: x[:, i] if cohort else x[i], batches)
            grads, loss = step_grad(w, batch)
            if variant == "prox":
                grads = grads + mu * (w.float() - global_params.float())
            if variant == "cm" and extra is not None:
                grads = cm_alpha * grads + (1.0 - cm_alpha) * extra
            updates, new_opt_state = opt.update(grads, opt_state, w, i)
            del grads       # a (K, N) stack each: drop them as they go
            new_w = w - updates
            del updates
            if mask is None:
                w, opt_state = new_w, new_opt_state
                loss_sum = loss_sum + loss
                nvalid = nvalid + 1.0
            else:
                # masked batches are no-ops
                valid = mask[..., i]
                keep = valid[..., None]
                w = torch.where(keep, new_w, w, out=new_w)
                opt_state = tree_map(lambda a, b: torch.where(keep, a, b),
                                     new_opt_state, opt_state)
                loss_sum = loss_sum + torch.where(valid, loss,
                                                  torch.zeros_like(loss))
                nvalid = nvalid + valid.float()
        if out is None:
            # w is this update's own buffer: the deltas take its place
            # (w_{t-1} - w as -w + w_{t-1}, the same rounding)
            delta = w.neg_().add_(global_params)
        else:
            delta = torch.sub(global_params, w, out=out)
        delta.div_(eta_l)
        return delta, loss_sum / torch.clamp(nvalid, min=1.0)

    return local_update


def make_local_update(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                      optimizer: str = "sgd", variant: str = "plain",
                      mu: float = 0.01, cm_alpha: float = 0.1,
                      ga_beta: float = 0.1):
    """fn(global_params (N,), batches (M, ...), mask (M,) or None,
    extra=None, out=None) -> (delta (N,), mean_loss ())."""
    return _build_local_update(loss_fn, layout, eta_l, optimizer, False,
                               variant, mu, cm_alpha, ga_beta)


def make_cohort_local_update(loss_fn: Callable, layout: FlatLayout,
                             eta_l: float, optimizer: str = "sgd",
                             variant: str = "plain", mu: float = 0.01,
                             cm_alpha: float = 0.1, ga_beta: float = 0.1):
    """fn(global_params (N,), batches (K, M, ...), masks (K, M) or None,
    extra=None, out=None) -> (deltas (K, N), losses (K,)); params and
    extra broadcast to every client."""
    return _build_local_update(loss_fn, layout, eta_l, optimizer, True,
                               variant, mu, cm_alpha, ga_beta)
