"""One FL round over a cohort: K local trainings, the chaos and codec
stages, then the server rule; counterpart of repro/core/round.py
(``make_cohort_round``, ``make_fl_round_step``, ``fl_round_input_specs``)
on the client axis.

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

``edges=E`` runs the server rule as the reference's two-level fold over
E equal contiguous row groups (core/baselines.py).

``group`` (a ``torch.distributed`` process group: the client axis of
launch/mesh.make_cohort_mesh) makes it the multi-process round. Each
rank holds the replicated params and server state and trains only its
contiguous slice of the padded cohort (sharding/rules.local_row_range);
a synchronous round then makes TWO collectives, both on the calling
(main) thread:

  1. one all-gather of the per-row scalars: each rank's reduction pass
     (``feddpc_dots``, or ``feddpc_guard_dots`` under the guard, over its
     rows) — <Δ_j,Δ_prev>, ||Δ_j||², ||Δ_prev||², the non-finite count —
     and its rows' losses. From them every rank forms the same guard
     decisions, coefs, scales, mask folding and diagnostics;
  2. one all-reduce (sum) of the rank's share of Δ_t (``RankShard``),
     after which every rank applies w' = w − η_g·Δ_t.

FedVARP gathers the cohort's rows instead of 2 (its table is replicated
state) and the error-feedback mean adds one all-reduce. The collectives
are timed on the round's stream (``cohort_round.shard``).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import FlatLayout, tree_leaves
from repro_torch.codec.base import DeltaCodec, sanitized_residual
from repro_torch.core import client as client_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import projection as proj
from repro_torch.core.baselines import (ServerAlgo, client_kwargs,
                                        make_algorithm)
from repro_torch.kernels.feddpc_project import ops as k_ops
from repro_torch.sharding.rules import edge_pieces, local_row_range

# out-of-range id for quarantined / deadline-dropped rows: FedVARP's table
# never writes a row for an id outside [0, num_clients)
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
    bad, cs, stats = guard_decisions(g[:, 1], g[:, 3], guard_thresh,
                                     guard_cfg)
    client_ids, client_mask = _quarantine(bad, client_ids, client_mask)
    return _clip_rows(deltas, cs, bad), client_ids, client_mask, stats


def guard_decisions(sqnorm: torch.Tensor, nonfinite: torch.Tensor,
                    guard_thresh: float, guard_cfg):
    """The guard's verdict on K rows from their ||Δ||² and non-finite
    counts: (bad (K,) bool, clip scales (K,) f32, stats)."""
    norm = torch.sqrt(sqnorm)
    # the limits in f32, as the reference multiplies f32 scalars
    q_lim = float(np.float32(guard_cfg.quarantine_mult)
                  * np.float32(guard_thresh))
    c_lim = float(np.float32(guard_cfg.clip_mult)
                  * np.float32(guard_thresh))
    bad = (nonfinite > 0) | (norm > q_lim)
    over = norm > c_lim
    cs = torch.where(over, c_lim / torch.clamp(norm, min=proj.EPS),
                     torch.ones_like(norm))
    stats = {"quarantined": bad, "clipped": ~bad & over,
             "norm": torch.clamp(norm, max=c_lim)}
    return bad, cs, stats


def _clip_rows(deltas, cs, bad):
    """The rows clipped by ``cs``, the bad ones zeroed (a new stack)."""
    return (deltas.float() * cs[:, None]).masked_fill_(bad[:, None], 0.0)


def _quarantine(bad, client_ids, client_mask):
    """Sentinel the bad rows' ids and fold them out of the mask."""
    client_ids = torch.where(
        bad, torch.full_like(client_ids, ID_SENTINEL, dtype=torch.int32),
        client_ids.to(torch.int32))
    client_mask = ~bad if client_mask is None else client_mask & ~bad
    return client_ids, client_mask


class RankShard:
    """This rank's rows of the padded cohort in a multi-process round and
    the round's collectives over the client axis's process ``group``.

    The rank holds rows [lo, hi) of ``rows`` (``local`` rows each rank);
    ``pieces`` are its rows cut at the ``edges`` boundaries
    (sharding/rules.edge_pieces), one fold launch each. ``dots`` is the
    gathered (rows, 3) reduction-pass scalars the rules read. Each
    collective is timed on the calling stream (CUDA events on the card,
    the host clock on the CPU) into ``timings``."""

    def __init__(self, group, local: int, edges: Optional[int] = None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.rows = local * self.world
        self.lo, self.hi = local_row_range(self.rank, self.world, self.rows)
        self.pieces = edge_pieces(self.lo, self.hi, self.rows, edges)
        self.dots: Optional[torch.Tensor] = None
        self.timings: List[tuple] = []

    def _run(self, name: str, x: torch.Tensor, op):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op()
            end.record()
            self.timings.append((name, start, end))
        else:
            tic = time.perf_counter()
            op()
            self.timings.append((name, tic, time.perf_counter()))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather of this rank's (local, ...) rows -> (rows, ...) in
        rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._run("all_gather", x,
                  lambda: dist.all_gather(parts, x, group=self.group))
        return torch.cat(parts)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of ``x`` over the ranks, in place."""
        self._run("all_reduce", x,
                  lambda: dist.all_reduce(x, group=self.group))
        return x

    def timings_ms(self) -> List[tuple]:
        """[(name, ms)] of the collectives so far; on the card this waits
        for their end events."""
        out = []
        for name, a, b in self.timings:
            if isinstance(a, float):
                out.append((name, 1e3 * (b - a)))
            else:
                b.synchronize()
                out.append((name, a.elapsed_time(b)))
        return out


def codec_stage(codec: DeltaCodec, deltas: torch.Tensor,
                ef: Optional[torch.Tensor], leaf_offsets: torch.Tensor,
                key=None):
    """The uplink, in the reference's order: every client ships Δ_j + ef
    (the server-held error-feedback accumulator, broadcast to every row),
    and the payload is encoded (a stochastic codec draws from ``key``,
    the round's PRNG key) and decoded. Returns (decoded (K, N) f32,
    payload, resid or None): with error feedback, ``resid`` is the
    sanitized quantization residual of this (pre-guard) decode, and the
    next accumulator is ``masked_client_mean(resid, client_mask)`` over
    the rows the round's deadline and guard leave."""
    shipped = deltas if ef is None else deltas + ef[None]
    payload = codec.encode_cohort(shipped, leaf_offsets, key=key)
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
                      fault_magnitude: float = 1e12, server_opt=None,
                      edges: Optional[int] = None, group=None,
                      real_clients: Optional[int] = None):
    """Returns cohort_round(server_state, params, batches, masks,
    client_ids, *extras) -> (new_params, new_server_state, losses (K,),
    diag[, guard_stats][, new_ef][, new_opt_state]).

    ``edges`` folds in two levels (core/baselines.py). With ``group`` the
    round is this rank's part of a multi-process round (module
    docstring): ``batches`` and ``masks`` hold the rank's rows only,
    while ``client_ids``, the extras' (K,) inputs, the losses and the
    guard stats cover the whole padded cohort. ``real_clients`` < K marks
    the rows from it on as padding, masked out of every mean.

    batches: a tree with leading axes (K, M, ...) on the params' device;
    masks (K, M) bool marks the valid minibatches (None = all valid).

    The extras follow the reference's FIXED order: ``inject_faults``
    appends (K,) int32 ``fault_codes`` (faults.CODE_*), ``deadline_mask``
    a (K,) bool ``live_mask`` (False = timed out: the row folds out of
    the client mask and its id becomes ``ID_SENTINEL``), ``guard`` a
    float ``guard_thresh`` and a trailing ``guard_stats`` output
    (``apply_guard``), a stochastic ``codec`` (int8_sr) the round's PRNG
    key (core/jax_prng.py), and ``codec_ef`` (with a LOSSY ``codec``) an
    (N,) error-feedback accumulator and a ``new_ef`` output after that.

    With a lossy codec the round aggregates the DECODED deltas; FedDPC's
    fold reads the payload itself only while no guard rewrites rows
    between decode and aggregation. Identity never enters the round."""
    local = client_mod.make_cohort_local_update(
        loss_fn, layout, eta_l, optimizer=optimizer,
        variant=algo.client_variant, **client_kwargs(algo))
    lossy = codec is not None and codec.lossy
    ef_active = lossy and codec_ef
    stochastic = lossy and codec.stochastic
    offsets = layout.leaf_offsets
    stack: Optional[torch.Tensor] = None
    if group is not None and stochastic:
        raise NotImplementedError(
            f"codec {codec.name!r} draws its noise over the whole cohort "
            "stack; a multi-process round encodes each rank's rows, which "
            "would draw other noise (ROADMAP Queue 1 item 13)")

    def cohort_round(server_state, params: torch.Tensor, batches,
                     masks: Optional[torch.Tensor], client_ids, *extras):
        nonlocal stack
        it = iter(extras)
        fault_codes = next(it) if inject_faults else None
        live_mask = next(it) if deadline_mask else None
        guard_thresh = next(it) if guard else None
        codec_key = next(it) if stochastic else None
        ef = next(it) if ef_active else None
        opt_state = next(it) if server_opt is not None else None
        k = tree_leaves(batches)[0].shape[0]
        if stack is None or stack.shape[0] != k or \
                stack.device != params.device:
            stack = torch.empty((k, params.shape[0]), dtype=torch.float32,
                                device=params.device)
        deltas, losses = local(params, batches, masks,
                               algo.client_extra(server_state), out=stack)
        shard = None if group is None else RankShard(group, k, edges)
        cohort_round.shard = shard
        rows = slice(None) if shard is None else slice(shard.lo, shard.hi)
        if inject_faults:
            deltas = apply_fault_codes(deltas, fault_codes[rows],
                                       fault_magnitude)
        cm = None
        if real_clients is not None:
            cm = torch.arange(client_ids.shape[0],
                              device=client_ids.device) < real_clients
        if deadline_mask:
            client_ids = torch.where(
                live_mask, client_ids.to(torch.int32),
                torch.full_like(client_ids, ID_SENTINEL, dtype=torch.int32))
            cm = live_mask if cm is None else cm & live_mask
        payload = resid = None
        if lossy:
            deltas, payload, resid = codec_stage(codec, deltas, ef,
                                                 offsets, codec_key)
        gstats = None
        if shard is not None:
            deltas, client_ids, cm, losses, gstats = _gather_rows(
                shard, algo, server_state, deltas, losses, client_ids, cm,
                guard_thresh if guard else None, guard_cfg)
        elif guard:
            # quarantine and clip read the DECODED rows: the values the
            # server would aggregate
            deltas, client_ids, cm, gstats = apply_guard(
                deltas, client_ids, cm, guard_thresh, guard_cfg)
        new_params, new_state, diag = algo.step(
            server_state, params, deltas, client_ids, eta_g, 0,
            client_mask=cm, encoded=None if guard else payload,
            leaf_offsets=offsets, edges=edges, shard=shard)
        outs = [new_params, new_state, losses, diag]
        if guard:
            outs.append(gstats)
        if ef_active:
            outs.append(proj.masked_client_mean(resid, cm, shard=shard))
        if server_opt is not None:
            outs[0], new_opt = server_opt.apply(params, new_params,
                                                opt_state)
            outs.append(new_opt)
        return tuple(outs)

    cohort_round.shard = None
    return cohort_round


def _gather_rows(shard: RankShard, algo: ServerAlgo, server_state, deltas,
                 losses, client_ids, cm, guard_thresh, guard_cfg):
    """The multi-process round's all-gather: this rank's reduction pass
    over its rows (what the guard and ``algo.row_scalars`` need) and its
    rows' losses, gathered in one collective as (rows, 5) f32 =
    [<Δ_j,Δ_prev>, ||Δ_j||², ||Δ_prev||², non-finite count, loss]. The
    guard then decides on every row alike and acts on this rank's; the
    dots of a clipped row are scaled with it (cs·<Δ_j,Δ_prev>,
    cs²·||Δ_j||²) and a quarantined row's are 0. Returns (deltas,
    client_ids, client_mask, losses (rows,), guard stats or None) and sets
    ``shard.dots``."""
    need = algo.row_scalars
    local = deltas.shape[0]
    prev = server_state["delta_prev"] if need == "dots" else None
    cols = torch.zeros((local, 5), dtype=torch.float32,
                       device=deltas.device)
    if guard_thresh is not None:
        cols[:, :4] = k_ops.feddpc_guard_dots(deltas, prev)
    elif need == "dots":
        cols[:, :3] = k_ops.feddpc_dots(deltas, prev)
    elif need == "sqnorm":
        cols[:, 1] = proj.tree_sqnorm(deltas)
    cols[:, 4] = losses
    g = shard.gather(cols)
    dp, dd = g[:, 0], g[:, 1]
    stats = None
    if guard_thresh is not None:
        bad, cs, stats = guard_decisions(g[:, 1], g[:, 3], guard_thresh,
                                         guard_cfg)
        rows = slice(shard.lo, shard.hi)
        deltas = _clip_rows(deltas, cs[rows], bad[rows])
        client_ids, cm = _quarantine(bad, client_ids, cm)
        zero = torch.zeros_like(dp)
        dp = torch.where(bad, zero, dp * cs)
        dd = torch.where(bad, zero, dd * cs * cs)
    shard.dots = torch.stack([dp, dd, g[:, 2]], dim=1)
    return deltas, client_ids, cm, g[:, 4].contiguous(), stats


def make_fl_round_step(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                       eta_g: float, lam: float = 1.0,
                       algorithm: str = "feddpc", *, group=None):
    """The cross-silo round: round_step(params (N,), delta_prev (N,),
    batches) -> (new_params, new_delta_prev, metrics), batches a tree
    with leading (K, M, ...) axes, all valid (fixed-shape silo streams:
    no mask). Takes any rule whose server state is exactly
    {"delta_prev"} (feddpc, fedavg, fedexp, ...); FedVARP and the other
    stateful rules need ``make_cohort_round``'s whole interface. With
    ``group`` the batches are this rank's K/world silos of a
    multi-process round (``make_cohort_round``'s). FedAvg's metrics hold
    the train loss alone, as the reference's (its FedAvg is the
    collective-volume baseline)."""
    hyper = {"lam": lam} if algorithm in ("feddpc", "feddpc_m") else None
    algo = make_algorithm(algorithm, hyper)
    probe = algo.init(torch.zeros(1), 1)
    if set(probe) != {"delta_prev"}:
        raise ValueError(
            f"make_fl_round_step supports algorithms whose server state is "
            f"exactly {{'delta_prev'}}; {algorithm!r} keeps {sorted(probe)} "
            f"— use make_cohort_round for stateful server rules")
    cohort = make_cohort_round(loss_fn, layout, algo, eta_l, eta_g,
                               group=group)

    def round_step(params, delta_prev, batches):
        k = tree_leaves(batches)[0].shape[0]
        world = 1 if group is None else dist.get_world_size(group)
        ids = torch.arange(k * world, dtype=torch.int32,
                           device=params.device)
        new_params, new_state, losses, diag = cohort(
            {"delta_prev": delta_prev}, params, batches, None, ids)
        if algorithm == "fedavg":
            diag = {}
        metrics = {"train_loss": losses.mean(), **diag}
        return new_params, new_state["delta_prev"], metrics

    return round_step


def fl_round_input_specs(cfg, *, clients: int, local_steps: int,
                         local_batch: int, seq_len: int):
    """The round's batch stack for LM training, as meta tensors of its
    shapes and dtypes (launch/steps.py's specs)."""
    shape = (clients, local_steps, local_batch, seq_len)
    meta = torch.device("meta")
    return {"tokens": torch.empty(shape, dtype=torch.int32, device=meta),
            "labels": torch.empty(shape, dtype=torch.int32, device=meta)}
