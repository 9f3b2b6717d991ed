"""One FL round over a cohort: K local trainings, the chaos and codec
stages, then the server rule; counterpart of repro/core/round.py
``make_cohort_round`` (without mesh, server optimizer or edges).

The K clients' deltas land in one (K, N) f32 stack — the layout the
FedDPC kernels read. The stack is allocated once and reused for every
round with the same K (its shape does not depend on the minibatch
bucket M); the reference gets the same effect by donating its buffers
to the jit'd round. Nothing keeps a row of it past the round: the
buffered-async waves, whose entries outlive their wave, train into
fresh stacks instead (core/api.py).

The chaos layer (core/faults.py, core/guards.py) enters the round in the
reference's order: injected faults right after local training, then the
deadline mask, then the codec's encode and decode, then the update guard
on the decoded rows, then the error-feedback mean over the rows that
survived. The guard's reduction pass is the ``feddpc_guard_dots`` kernel
on the card.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import FlatLayout, tree_leaves
from repro_torch.codec.base import DeltaCodec, sanitized_residual
from repro_torch.core import client as client_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import projection as proj
from repro_torch.core.baselines import ServerAlgo
from repro_torch.kernels.feddpc_project import ops as k_ops

# out-of-range id for quarantined / deadline-dropped rows: the reference's
# FedVARP table (not ported yet) drops only out-of-range ids, and the ids
# are part of what a round hands the server rule
ID_SENTINEL = 2_147_483_647      # the largest int32


def apply_fault_codes(deltas: torch.Tensor, fault_codes: torch.Tensor,
                      magnitude: float) -> torch.Tensor:
    """Chaos harness (core/faults.py): corrupt the coded rows of a (K, N)
    delta stack — CODE_NAN fills the row with NaN, CODE_EXPLODE multiplies
    it by ``magnitude`` (in f32), every other row is multiplied by 1.0 —
    after local training, before validation and aggregation. Returns a
    new stack."""
    codes = fault_codes.to(deltas.device)
    mult = torch.where(codes == faults_mod.CODE_EXPLODE,
                       torch.tensor(magnitude, dtype=torch.float32,
                                    device=deltas.device),
                       torch.ones((), device=deltas.device))
    out = deltas.float() * mult[:, None]
    return out.masked_fill_((codes == faults_mod.CODE_NAN)[:, None],
                            float("nan"))


def apply_guard(deltas: torch.Tensor, client_ids: torch.Tensor,
                client_mask: Optional[torch.Tensor], guard_thresh: float,
                guard_cfg):
    """Update-guard validation (core/guards.py) on a (K, N) stack: the
    per-row ||Δ||² and non-finite count from ``feddpc_guard_dots``
    (without Δ_prev), quarantine on any non-finite entry or
    ||Δ|| > quarantine_mult x thresh, clip to clip_mult x thresh
    otherwise.

    Quarantined rows are ZEROED — folding them out of the mask is not
    enough, since a masked row still multiplies into the fold
    (0 x NaN = NaN) — their ids become ``ID_SENTINEL`` and they fold into
    ``client_mask``. With thresh = +inf and finite rows every multiplier
    is exactly 1.0: the guarded round computes the unguarded one.
    Returns (deltas, client_ids, client_mask, stats) with stats =
    {"quarantined": (K,) bool, "clipped": (K,) bool, "norm": (K,) f32
    post-clip norms}.

    The norm of a row with non-finite entries is taken over its finite
    entries (the kernel zeroes the others), where the reference's is
    NaN or inf. Such a row is quarantined either way, and the trainer
    reads the norms of the rows that were not."""
    g = k_ops.feddpc_guard_dots(deltas)
    norm = torch.sqrt(g[:, 1])
    # the limits in f32, as the reference multiplies f32 scalars
    q_lim = float(np.float32(guard_cfg.quarantine_mult)
                  * np.float32(guard_thresh))
    c_lim = float(np.float32(guard_cfg.clip_mult)
                  * np.float32(guard_thresh))
    bad = (g[:, 3] > 0) | (norm > q_lim)
    over = norm > c_lim
    cs = torch.where(over, c_lim / torch.clamp(norm, min=proj.EPS),
                     torch.ones_like(norm))
    clipped = ~bad & over
    out = (deltas.float() * cs[:, None]).masked_fill_(bad[:, None], 0.0)
    client_ids = torch.where(
        bad, torch.full_like(client_ids, ID_SENTINEL, dtype=torch.int32),
        client_ids.to(torch.int32))
    client_mask = ~bad if client_mask is None else client_mask & ~bad
    stats = {"quarantined": bad, "clipped": clipped,
             "norm": torch.clamp(norm, max=c_lim)}
    return out, client_ids, client_mask, stats


def codec_stage(codec: DeltaCodec, deltas: torch.Tensor,
                ef: Optional[torch.Tensor], leaf_offsets: torch.Tensor):
    """The uplink, in the reference's order: every client ships Δ_j + ef
    (the server-held error-feedback accumulator, broadcast to every row),
    and the payload is encoded and decoded. Returns (decoded (K, N) f32,
    payload, resid or None): with error feedback, ``resid`` is the
    sanitized quantization residual of this (pre-guard) decode, and the
    next accumulator is ``masked_client_mean(resid, client_mask)`` over
    the rows the round's deadline and guard leave."""
    shipped = deltas if ef is None else deltas + ef[None]
    payload = codec.encode_cohort(shipped, leaf_offsets)
    decoded = codec.decode_cohort(payload, leaf_offsets)
    resid = None if ef is None else sanitized_residual(shipped, decoded)
    return decoded, payload, resid


def make_cohort_round(loss_fn: Callable, layout: FlatLayout,
                      algo: ServerAlgo, eta_l: float, eta_g: float, *,
                      optimizer: str = "sgd",
                      codec: Optional[DeltaCodec] = None,
                      codec_ef: bool = False,
                      guard: bool = False, guard_cfg=None,
                      inject_faults: bool = False,
                      deadline_mask: bool = False,
                      fault_magnitude: float = 1e12):
    """Returns cohort_round(server_state, params, batches, masks,
    client_ids, *extras) -> (new_params, new_server_state, losses (K,),
    diag[, guard_stats][, new_ef]).

    batches: a tree with leading axes (K, M, ...) on the params' device;
    masks (K, M) bool marks the valid minibatches (None = all valid).

    The extras follow the reference's FIXED order: ``inject_faults``
    appends (K,) int32 ``fault_codes`` (faults.CODE_*), ``deadline_mask``
    a (K,) bool ``live_mask`` (False = timed out: the row folds out of
    the client mask and its id becomes ``ID_SENTINEL``), ``guard`` a
    float ``guard_thresh`` and a trailing ``guard_stats`` output
    (``apply_guard``), and ``codec_ef`` (with a LOSSY ``codec``) an (N,)
    error-feedback accumulator and a ``new_ef`` output after that.

    With a lossy codec the round aggregates the DECODED deltas; FedDPC's
    fold reads the payload itself only while no guard rewrites rows
    between decode and aggregation. Identity never enters the round."""
    local = client_mod.make_cohort_local_update(loss_fn, layout, eta_l,
                                                optimizer=optimizer)
    lossy = codec is not None and codec.lossy
    ef_active = lossy and codec_ef
    offsets = layout.leaf_offsets
    stack: Optional[torch.Tensor] = None

    def cohort_round(server_state, params: torch.Tensor, batches,
                     masks: Optional[torch.Tensor], client_ids, *extras):
        nonlocal stack
        it = iter(extras)
        fault_codes = next(it) if inject_faults else None
        live_mask = next(it) if deadline_mask else None
        guard_thresh = next(it) if guard else None
        ef = next(it) if ef_active else None
        k = tree_leaves(batches)[0].shape[0]
        if stack is None or stack.shape[0] != k or \
                stack.device != params.device:
            stack = torch.empty((k, params.shape[0]), dtype=torch.float32,
                                device=params.device)
        deltas, losses = local(params, batches, masks, out=stack)
        if inject_faults:
            deltas = apply_fault_codes(deltas, fault_codes, fault_magnitude)
        cm = None
        if deadline_mask:
            client_ids = torch.where(
                live_mask, client_ids.to(torch.int32),
                torch.full_like(client_ids, ID_SENTINEL, dtype=torch.int32))
            cm = live_mask
        payload = resid = None
        if lossy:
            deltas, payload, resid = codec_stage(codec, deltas, ef,
                                                 offsets)
        gstats = None
        if guard:
            # quarantine and clip read the DECODED rows: the values the
            # server would aggregate
            deltas, client_ids, cm, gstats = apply_guard(
                deltas, client_ids, cm, guard_thresh, guard_cfg)
        new_params, new_state, diag = algo.step(
            server_state, params, deltas, client_ids, eta_g, 0,
            client_mask=cm, encoded=None if guard else payload,
            leaf_offsets=offsets)
        outs = [new_params, new_state, losses, diag]
        if guard:
            outs.append(gstats)
        if ef_active:
            outs.append(proj.masked_client_mean(resid, cm))
        return tuple(outs)

    return cohort_round
