"""One FL round over a cohort: K local trainings, the codec stage, then
the server rule; counterpart of repro/core/round.py ``make_cohort_round``
(without faults, guard, mesh, server optimizer or edges in this slice).

The K clients' deltas land in one (K, N) f32 stack — the layout the
FedDPC kernels read. The stack is allocated once and reused for every
round with the same K (its shape does not depend on the minibatch
bucket M); the reference gets the same effect by donating its buffers
to the jit'd round. Nothing keeps a row of it past the round: the
buffered-async waves, whose entries outlive their wave, train into
fresh stacks instead (core/api.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.bridge import FlatLayout, tree_leaves
from repro_torch.codec.base import DeltaCodec, sanitized_residual
from repro_torch.core import client as client_mod
from repro_torch.core import projection as proj
from repro_torch.core.baselines import ServerAlgo


def codec_stage(codec: DeltaCodec, deltas: torch.Tensor,
                ef: Optional[torch.Tensor], leaf_offsets: torch.Tensor):
    """The uplink, in the reference's order: every client ships Δ_j + ef
    (the server-held error-feedback accumulator, broadcast to every row),
    the payload is encoded and decoded, and the new accumulator is the
    client mean of the sanitized quantization residuals. Returns
    (decoded (K, N) f32, payload, new_ef or None)."""
    shipped = deltas if ef is None else deltas + ef[None]
    payload = codec.encode_cohort(shipped, leaf_offsets)
    decoded = codec.decode_cohort(payload, leaf_offsets)
    new_ef = (None if ef is None else proj.masked_client_mean(
        sanitized_residual(shipped, decoded)))
    return decoded, payload, new_ef


def make_cohort_round(loss_fn: Callable, layout: FlatLayout,
                      algo: ServerAlgo, eta_l: float, eta_g: float, *,
                      optimizer: str = "sgd",
                      codec: Optional[DeltaCodec] = None):
    """Returns cohort_round(server_state, params, batches, masks,
    client_ids, ef=None) -> (new_params, new_server_state, losses (K,),
    diag, new_ef).

    batches: a tree with leading axes (K, M, ...) on the params' device;
    masks (K, M) bool marks the valid minibatches (None = all valid).

    With a LOSSY ``codec`` the round aggregates the DECODED deltas, and
    FedDPC's fold reads the payload itself; ``ef`` (N,) switches on
    error feedback and ``new_ef`` is the next accumulator (None without
    it). Identity never enters the round."""
    local = client_mod.make_cohort_local_update(loss_fn, layout, eta_l,
                                                optimizer=optimizer)
    lossy = codec is not None and codec.lossy
    offsets = layout.leaf_offsets
    stack: Optional[torch.Tensor] = None

    def cohort_round(server_state, params: torch.Tensor, batches,
                     masks: Optional[torch.Tensor], client_ids,
                     ef: Optional[torch.Tensor] = None):
        nonlocal stack
        k = tree_leaves(batches)[0].shape[0]
        if stack is None or stack.shape[0] != k or \
                stack.device != params.device:
            stack = torch.empty((k, params.shape[0]), dtype=torch.float32,
                                device=params.device)
        deltas, losses = local(params, batches, masks, out=stack)
        payload = new_ef = None
        if lossy:
            deltas, payload, new_ef = codec_stage(codec, deltas, ef, offsets)
        new_params, new_state, diag = algo.step(
            server_state, params, deltas, client_ids, eta_g, 0,
            encoded=payload, leaf_offsets=offsets)
        return new_params, new_state, losses, diag, new_ef

    return cohort_round
