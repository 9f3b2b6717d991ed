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
fresh stacks instead (core/api.py). So does the tensor-parallel route
(below): its deltas take the working copies' own buffer, one (K, N_m)
buffer less at the backward's peak.

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

``model_group`` and ``shards`` (the model axis of a two-axis
(clients, model) mesh, launch/mesh.make_cohort_mesh(model=M);
sharding/layout.ShardLayout) make params, server state, the optimizer's
moments and the error-feedback accumulator the rank's SHARDS at rest
(N_m of the N columns). The round then makes five kinds of collective:

  3. ``param_all_gather``: the params (and a cm/ga rule's Δ_prev) are
     gathered within the model group; each model rank trains its share
     of the client slice's rows at full width
     (sharding/rules.model_row_split; the padding stays the client
     axis's, so edges and masks do not move);
  4. ``all_to_all``: each delta's shards go to their owners, from
     isend/irecv pairs (uneven splits), after which every tensor is the
     rank's shard of its slice's rows;
  5. ``model_sum``: the reduction pass's partial scalars (and the rows'
     losses) are summed over the model group before 1. gathers them,
     and the diagnostics' norms and dots after the fold;

plus 1. and 2. as above, on the client group. A codec's per-leaf
extrema add one all-gather over the model group (``leaf_extrema``), so
each shard quantizes with the whole leaf's scale.

That is the row split, the route of the vision models (their
convolutions have no Megatron form in the reference's rules). A task
whose loss trains tensor-parallel — transformer.LMLoss of any decoder
family or Whisper's widths — takes the reference's own route instead, chosen once when the
round is built (``cohort_local_update``): every model rank trains all of
the slice's rows on its shard, Megatron-parallel
(sharding/tensor_parallel.py, sharding/layout.TPView), so 3. and 4. go
away. Its collectives run inside the local update's forward and
backward, over the model group: ``tp_all_reduce`` (the activations
after each row-parallel layer, their gradients before each
column-parallel one, the vocab-parallel embedding and cross entropy)
and ``tp_leaf_gather`` (the leaves that need whole values, once a local
step). The rows' losses, the same on every model rank, are placed on
model rank 0 alone before 5.

A buffered-async wave across ranks is a RankShard's local training,
exchange and encode, its losses summed over the job; its fold is a
``BufferShard``: the rank holds an index set of the buffer's arrivals,
whose row scalars are summed over the job in one all-reduce
(``buffer_scalars``) before the fold's one launch over the held rows and
the all-reduce of Δ_t; FedVARP's table takes the buffer's rows from the
client slices (``buffer_rows``).
"""
from __future__ import annotations

import functools
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
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.sharding.layout import ShardLayout, TPView
from repro_torch.sharding.rules import (cohort_param_specs, edge_pieces,
                                        local_row_range, mesh_axes,
                                        model_row_split, spec_leaves)

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


def _p2p_exchange(sends, recvs, group) -> None:
    """Send ``sends[peer]`` to and receive into ``recvs[peer]`` from each
    peer (global ranks) at once, as isend/irecv pairs. Gloo moves host
    memory only, so under gloo CUDA tensors travel through host copies."""
    host = dist.get_backend(group) == "gloo"

    def wire(t, send):
        if not (host and t.is_cuda):
            return t
        return t.cpu() if send else torch.empty(t.shape, dtype=t.dtype)
    bufs = {p: wire(t, False) for p, t in recvs.items()}
    ops = [dist.P2POp(dist.isend, wire(t.contiguous(), True), p, group)
           for p, t in sends.items()]
    ops += [dist.P2POp(dist.irecv, b, p, group) for p, b in bufs.items()]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for p, t in recvs.items():
        if bufs[p] is not t:
            t.copy_(bufs[p])


def model_all_gather(x: torch.Tensor, group, shards) -> torch.Tensor:
    """The (..., N) tensor from each model rank's (..., N_m) shard:
    one all-gather over the model ``group``, every shard padded to the
    widest (sharding/layout.ShardLayout.unpad)."""
    m = dist.get_rank(group)
    lead = tuple(x.shape[:-1])
    pad = x.new_zeros(lead + (shards.max_size,))
    pad[..., :shards.sizes[m]] = x
    parts = [torch.empty_like(pad) for _ in range(shards.model)]
    dist.all_gather(parts, pad, group=group)
    return shards.unpad(torch.stack(parts, dim=-2))


class _Collectives:
    """The collectives a rank's part of a multi-process round makes, each
    timed on the calling stream (CUDA events on the card, the host clock
    on the CPU) into ``timings``: over the client axis's process
    ``group``, over the job, and, on a two-axis mesh, over the
    ``model_group`` with the params' ``shards``
    (sharding/layout.ShardLayout). ``dots`` is the (rows, 3)
    reduction-pass scalars the rules read, summed over the model ranks
    and combined over the client axis."""

    def __init__(self, group, model_group=None, shards=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.model_group = model_group
        self.shards = shards
        if model_group is None:
            self.model, self.mrank = 1, 0
        else:
            self.model = dist.get_world_size(model_group)
            self.mrank = dist.get_rank(model_group)
            self.peers = dist.get_process_group_ranks(model_group)
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

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of ``x`` over the client axis, in place."""
        self._run("all_reduce", x,
                  lambda: dist.all_reduce(x, group=self.group))
        return x

    def job_sum(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """All-reduce (sum) of ``x`` over every rank of the job, in place:
        the client axis's and the model axis's partials in one
        collective (the client axis itself without the model axis)."""
        x = x.contiguous()
        group = self.group if self.model == 1 else None
        self._run(name, x, lambda: dist.all_reduce(x, group=group))
        return x

    # ---- the model axis ----

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of a shard's partial scalars over the model
        axis, in place; ``x`` itself without the model axis."""
        if self.model == 1:
            return x
        x = x.contiguous()
        self._run("model_sum", x,
                  lambda: dist.all_reduce(x, group=self.model_group))
        return x

    def gather_params(self, x: torch.Tensor) -> torch.Tensor:
        """The full (N,) vector from the model ranks' shards."""
        out = []
        self._run("param_all_gather", x, lambda: out.append(
            model_all_gather(x, self.model_group, self.shards)))
        return out[0]

    def leaf_extrema(self, mn: torch.Tensor, mx: torch.Tensor):
        """Per (row, held leaf) min and max of the shard -> those of the
        whole leaf: the model ranks' (2, local, L) partials, filled with
        +inf / -inf where a rank holds none of a leaf, are all-gathered
        and reduced on every rank (amin/amax keep a NaN, as the
        reference's jnp.min does; a MIN/MAX all-reduce need not)."""
        ids = torch.from_numpy(self.shards.leaf_ids(self.mrank)
                               ).to(mn.device)
        nleaves = len(self.shards.layout.shapes)
        part = torch.empty((2, mn.shape[0], nleaves), dtype=torch.float32,
                           device=mn.device)
        part[0].fill_(float("inf"))
        part[1].fill_(float("-inf"))
        part[0][:, ids] = mn
        part[1][:, ids] = mx
        parts = [torch.empty_like(part) for _ in range(self.model)]
        self._run("leaf_extrema", part, lambda: dist.all_gather(
            parts, part, group=self.model_group))
        g = torch.stack(parts)
        return (torch.amin(g[:, 0], dim=0)[:, ids].contiguous(),
                torch.amax(g[:, 1], dim=0)[:, ids].contiguous())

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


class RankShard(_Collectives):
    """This rank's part of a multi-process round (or of an async wave) and
    its collectives (``_Collectives``).

    The rank's client slice is rows [lo, hi) of the ``rows`` padded
    cohort rows (``local`` each); ``pieces`` are those rows cut at the
    ``edges`` boundaries (sharding/rules.edge_pieces), one fold launch
    each. Without the model axis the rank trains its whole slice. With
    it, on the tensor-parallel route (``tp``, the model group's
    sharding/tensor_parallel.TPContext) every model rank trains all of
    the slice's rows on its own shard; otherwise model rank ``mrank`` of
    ``model`` trains rows ``train`` of the slice at full width
    (sharding/rules.model_row_split), and from the all-to-all on every
    tensor is the rank's shard of N_m columns."""

    def __init__(self, group, rows: int, edges: Optional[int] = None, *,
                 model_group=None, shards=None, tp=None):
        super().__init__(group, model_group, shards)
        self.rows = int(rows)
        self.local = self.rows // self.world
        self.lo, self.hi = local_row_range(self.rank, self.world, self.rows)
        self.pieces = edge_pieces(self.lo, self.hi, self.rows, edges)
        self.tp = tp
        if model_group is None or tp is not None:
            self.train = (self.lo, self.hi)
        else:
            self.splits = model_row_split(self.lo, self.hi, self.model)
            self.train = self.splits[self.mrank]

    def local_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (rows, ...) tensor."""
        return v[self.lo:self.hi]

    def fold_pieces(self) -> List[tuple]:
        """[(local rows, global rows, row count)] of the fold's launches:
        one per edge piece."""
        return [(slice(a - self.lo, b - self.lo), slice(a, b), b - a)
                for a, b in self.pieces]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather of this client slice's (local, ...) rows ->
        (rows, ...) in row order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._run("all_gather", x,
                  lambda: dist.all_gather(parts, x, group=self.group))
        return torch.cat(parts)

    def row_scalars(self, cols: torch.Tensor) -> torch.Tensor:
        """The slice's (local, c) row scalars, model-summed, gathered
        over the client axis -> (rows, c)."""
        return self.gather(self.model_sum(cols))

    def local_training(self, local, params: torch.Tensor, batches, masks,
                       extra, out: Optional[torch.Tensor] = None):
        """Local training of the rows this rank trains. On the
        tensor-parallel route every model rank trains the slice's rows on
        its shard (the model group's collectives inside the loss, timed
        here as "tp_all_reduce" and "tp_leaf_gather"); the rows' losses,
        the same on every model rank, are placed on model rank 0 alone,
        so a sum over the model group counts them once. Otherwise, on the
        model axis, the params (and a cm/ga rule's Δ_prev) are gathered
        within the model group first, the rank trains its rows at full
        width, and the all-to-all then hands each delta's shards to their
        owners. Returns (the client slice's (local, N_m) deltas, its
        (local,) losses: the rows this rank trained, 0 at the others)."""
        if self.tp is not None:
            self.tp.timer = self._run
            deltas, losses = local(params, batches, masks, extra, out=out)
            if self.mrank:
                losses = torch.zeros_like(losses)
            return deltas, losses
        if self.model_group is not None:
            params = self.gather_params(params)
            if extra is not None:
                extra = self.gather_params(extra)
        deltas, losses = local(params, batches, masks, extra, out=out)
        if self.model_group is None:
            return deltas, losses
        del params
        deltas = self.exchange(deltas)
        placed = torch.zeros(self.local, dtype=losses.dtype,
                             device=losses.device)
        a = self.train[0] - self.lo
        placed[a:a + losses.shape[0]] = losses
        return deltas, placed

    # ---- the model axis ----

    def exchange(self, trained: torch.Tensor) -> torch.Tensor:
        """The all-to-all: this rank's (trained rows, N) deltas at full
        width -> the client slice's (local, N_m) deltas of its own shard,
        each model rank's rows sent the columns it owns. Built from
        isend/irecv pairs (uneven splits; gloo takes no all-to-all of
        CUDA tensors)."""
        m, sh = self.mrank, self.shards
        out = trained.new_empty((self.local, sh.sizes[m]))
        off = lambda r: self.splits[r][0] - self.lo
        sends, recvs = {}, {}
        for r, peer in enumerate(self.peers):
            a, b = self.splits[r]
            if r == m:
                sh.scatter(trained, r, out=out[off(r):off(r) + b - a])
            else:
                sends[peer] = sh.scatter(trained, r)
                recvs[peer] = out[off(r):off(r) + b - a]
        self._run("all_to_all", trained,
                  lambda: _p2p_exchange(sends, recvs, self.model_group))
        return out


class BufferShard(_Collectives):
    """This rank's part of a buffered-async fold across ranks
    (core/api.py): every rank folds the same ``rows`` arrivals, in the
    same order, and holds the deltas of those at buffer positions
    ``held`` — the arrivals its client slice trained (or was given at a
    restore), on the model axis as its shard's N_m columns. The held
    rows are an index set of the buffer, not a contiguous range: a
    fold's arrivals come from several waves, in arrival order.

    The rows' scalars are placed at their positions and summed over the
    job (``row_scalars``): the model ranks' partials and the client
    slices' disjoint rows in one all-reduce, so every rank forms the
    same guard decisions, coefs, scales and diagnostics. The fold is one
    launch over the held rows (none without any), its mean rescaled to
    the held share of the buffer and summed over the client axis."""

    def __init__(self, group, rows: int, held, *, model_group=None,
                 shards=None, device=None):
        super().__init__(group, model_group, shards)
        self.rows = int(rows)
        self.held = torch.as_tensor(np.asarray(held, np.int64),
                                    device=device)
        self.local = int(self.held.numel())

    def local_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (rows, ...) tensor, in buffer order."""
        return v.index_select(0, self.held.to(v.device))

    def fold_pieces(self) -> List[tuple]:
        """One launch over the held rows; none when the rank holds no
        arrival of the fold (it still joins the sums)."""
        if not self.local:
            return []
        return [(slice(0, self.local), self.held, self.local)]

    def _placed(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((self.rows,) + tuple(x.shape[1:]))
        out[self.held.to(x.device)] = x
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The buffer's (rows, ...) rows from each client slice's held
        (local, ...) ones: each placed at its positions, zeros elsewhere,
        and summed over the client axis (exact: one slice holds each
        row)."""
        placed = self._placed(x)
        self._run("buffer_rows", placed,
                  lambda: dist.all_reduce(placed, group=self.group))
        return placed

    def row_scalars(self, cols: torch.Tensor) -> torch.Tensor:
        """The held rows' (local, c) scalars -> the buffer's (rows, c):
        one all-reduce over the job."""
        return self.job_sum(self._placed(cols), "buffer_scalars")


def codec_stage(codec: DeltaCodec, deltas: torch.Tensor,
                ef: Optional[torch.Tensor], leaf_offsets: torch.Tensor,
                key=None, shard: Optional[RankShard] = None):
    """The uplink, in the reference's order: every client ships Δ_j + ef
    (the server-held error-feedback accumulator, broadcast to every row),
    and the payload is encoded (a stochastic codec draws from ``key``,
    the round's PRNG key) and decoded. Returns (decoded (K, N) f32,
    payload, resid or None): with error feedback, ``resid`` is the
    sanitized quantization residual of this (pre-guard) decode, and the
    next accumulator is ``masked_client_mean(resid, client_mask)`` over
    the rows the round's deadline and guard leave. With ``shard`` the
    rows are a rank's block of the cohort (and, on the model axis, its
    shard's columns): the codec takes the whole leaves' scales and the
    whole stack's noise (codec/codecs.py)."""
    shipped = deltas if ef is None else deltas + ef[None]
    kw = {} if shard is None else {"shard": shard}
    payload = codec.encode_cohort(shipped, leaf_offsets, key=key, **kw)
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
                      model_group=None, shards=None,
                      real_clients: Optional[int] = None):
    """Returns cohort_round(server_state, params, batches, masks,
    client_ids, *extras) -> (new_params, new_server_state, losses (K,),
    diag[, guard_stats][, new_ef][, new_opt_state]).

    ``edges`` folds in two levels (core/baselines.py). With ``group`` the
    round is this rank's part of a multi-process round (module
    docstring): ``batches`` and ``masks`` hold the rows the rank trains,
    while ``client_ids``, the extras' (K,) inputs, the losses and the
    guard stats cover the whole padded cohort. ``model_group`` and
    ``shards`` (sharding/layout.ShardLayout) add the model axis: params,
    server state, the error-feedback accumulator and the optimizer's
    moments are then this rank's shards. ``real_clients`` < K marks the
    rows from it on as padding, masked out of every mean.

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
    local, tp = cohort_local_update(loss_fn, layout, algo, eta_l, optimizer,
                                    model_group, shards)
    lossy = codec is not None and codec.lossy
    ef_active = lossy and codec_ef
    stochastic = lossy and codec.stochastic
    sharded = model_group is not None
    offsets = (shards.offsets(dist.get_rank(model_group)) if sharded
               else layout.leaf_offsets)
    stack: Optional[torch.Tensor] = None

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
        shard = None if group is None else RankShard(
            group, client_ids.shape[0], edges, model_group=model_group,
            shards=shards, tp=tp)
        cohort_round.shard = shard
        extra = algo.client_extra(server_state)
        k = tree_leaves(batches)[0].shape[0]
        if tp is not None:
            stack = None    # the deltas take the working copies' buffer
        elif stack is None or stack.shape[0] != k or \
                stack.device != params.device:
            stack = torch.empty((k, layout.size), dtype=torch.float32,
                                device=params.device)
        if shard is None:
            deltas, losses = local(params, batches, masks, extra, out=stack)
        else:
            # from here on every tensor is this rank's shard
            deltas, losses = shard.local_training(local, params, batches,
                                                  masks, extra, out=stack)
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
                                                 offsets, codec_key, shard)
        gstats = None
        if shard is not None:
            deltas, client_ids, cm, losses, gstats = shard_row_scalars(
                shard, algo, server_state, deltas, client_ids, cm,
                guard_thresh if guard else None, guard_cfg, losses=losses)
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
    cohort_round.tp = tp        # the route: None trains full-width rows
    return cohort_round


def cohort_local_update(loss_fn: Callable, layout: FlatLayout,
                        algo: ServerAlgo, eta_l: float, optimizer: str = "sgd",
                        model_group=None, shards=None):
    """The cohort local update of ``algo``'s client variant and its
    sharding/tensor_parallel.TPContext, or None. The route is chosen
    here, once, from the task's model family: on the model axis a loss
    that trains tensor-parallel (``tensor_parallel.trains_tensor_parallel``:
    transformer.LMLoss of every decoder family) trains (K, N_m)
    working copies of the rank's shard through sharding/layout.TPView;
    any other (the vision models, whose convolutions have no Megatron
    form in the reference's rules) trains full-width rows of the gathered
    params (RankShard)."""
    tp = None
    if model_group is not None and tpm.trains_tensor_parallel(loss_fn):
        tp = tpm.TPContext.of(model_group)
        layout = TPView(shards, tp.rank, loss_fn.cfg, tp)
        loss_fn = functools.partial(loss_fn, tp=tp)
    local = client_mod.make_cohort_local_update(
        loss_fn, layout, eta_l, optimizer=optimizer,
        variant=algo.client_variant, **client_kwargs(algo))
    return local, tp


def shard_row_scalars(shard, algo: ServerAlgo, server_state, deltas,
                      client_ids, cm, guard_thresh, guard_cfg, losses=None,
                      row_weights=None):
    """The multi-process step's row scalars: this rank's reduction pass
    over its rows (what the guard and ``algo.row_scalars`` need), as
    (local, 4) f32 = [<Δ_j,Δ_prev>, ||Δ_j||², ||Δ_prev||², non-finite
    count], with the rows' ``losses`` as a fifth column when given,
    combined into the (rows, c) scalars of every row by
    ``shard.row_scalars`` (a RankShard's model sum and client gather, a
    BufferShard's one sum over the job). The guard then decides on every
    row alike and acts on this rank's; the dots of a clipped row are
    scaled with it (cs·<Δ_j,Δ_prev>, cs²·||Δ_j||²) and a quarantined
    row's are 0. ``row_weights`` (rows,) are the async discounts a rule
    that is not staleness-aware gets pre-scaled into its rows: its dots
    scale with them (w·<Δ_j,Δ_prev>, w²·||Δ_j||²). A rank without rows
    launches no reduction and still joins the sum; with nothing to read
    (no guard, no row scalars, no losses) nothing is combined. Returns
    (deltas, client_ids, client_mask, losses (rows,) or None, guard stats
    or None) and sets ``shard.dots``."""
    need = algo.row_scalars
    if guard_thresh is None and need is None and losses is None:
        return deltas, client_ids, cm, None, None
    local = deltas.shape[0]
    prev = server_state["delta_prev"] if need == "dots" else None
    cols = torch.zeros((local, 4 if losses is None else 5),
                       dtype=torch.float32, device=deltas.device)
    if local and guard_thresh is not None:
        cols[:, :4] = k_ops.feddpc_guard_dots(deltas, prev)
    elif local and need == "dots":
        cols[:, :3] = k_ops.feddpc_dots(deltas, prev)
    elif need == "sqnorm":
        cols[:, 1] = proj.tree_sqnorm(deltas)
    if losses is not None:
        cols[:, 4] = losses
    g = shard.row_scalars(cols)
    dp, dd = g[:, 0], g[:, 1]
    stats = None
    if guard_thresh is not None:
        bad, cs, stats = guard_decisions(g[:, 1], g[:, 3], guard_thresh,
                                         guard_cfg)
        deltas = _clip_rows(deltas, shard.local_rows(cs),
                            shard.local_rows(bad))
        client_ids, cm = _quarantine(bad, client_ids, cm)
        zero = torch.zeros_like(dp)
        dp = torch.where(bad, zero, dp * cs)
        dd = torch.where(bad, zero, dd * cs * cs)
    if row_weights is not None:
        dp = dp * row_weights
        dd = dd * row_weights * row_weights
    shard.dots = torch.stack([dp, dd, g[:, 2]], dim=1)
    return (deltas, client_ids, cm,
            None if losses is None else g[:, 4].contiguous(), stats)


def make_fl_round_step(loss_fn: Callable, layout: FlatLayout, eta_l: float,
                       eta_g: float, lam: float = 1.0,
                       algorithm: str = "feddpc", *, group=None, mesh=None,
                       params_template=None):
    """The cross-silo round: round_step(params (N,), delta_prev (N,),
    batches) -> (new_params, new_delta_prev, metrics), batches a tree
    with leading (K, M, ...) axes, all valid (fixed-shape silo streams:
    no mask). Takes any rule whose server state is exactly
    {"delta_prev"} (feddpc, fedavg, fedexp, ...); FedVARP and the other
    stateful rules need ``make_cohort_round``'s whole interface. With
    ``group`` (or a 1-D cohort ``mesh``) the batches are this rank's
    K/world silos of a multi-process round (``make_cohort_round``'s).

    On a two-axis (clients, model) ``mesh`` params and delta_prev are
    this rank's shards under ``cohort_param_specs(params_template,
    mesh)`` (the reference's tree of the params; shapes only); it raises
    without ``params_template``, as the reference does. A ``loss_fn``
    that trains tensor-parallel (transformer.LMLoss)
    takes the reference's route — each silo a model-parallel replica,
    Megatron-sharded over ``model``: the batches are the client slice's
    silos, the same on each of its model ranks. Any other loss trains
    full-width rows: the batches are the silos this rank trains, and
    the round's silo count K is their sum over the ranks, taken once.
    FedAvg's metrics hold the train loss alone, as the reference's (its
    FedAvg is the collective-volume baseline)."""
    hyper = {"lam": lam} if algorithm in ("feddpc", "feddpc_m") else None
    algo = make_algorithm(algorithm, hyper)
    probe = algo.init(torch.zeros(1), 1)
    if set(probe) != {"delta_prev"}:
        raise ValueError(
            f"make_fl_round_step supports algorithms whose server state is "
            f"exactly {{'delta_prev'}}; {algorithm!r} keeps {sorted(probe)} "
            f"— use make_cohort_round for stateful server rules")
    model_group = shards = None
    if mesh is not None:
        sizes = mesh_axes(mesh)
        if sizes.get("model", 1) > 1:
            if params_template is None:
                raise ValueError(
                    f"mesh carries a 'model' axis of size "
                    f"{sizes['model']}: make_fl_round_step needs "
                    "params_template= for the per-leaf model specs")
            specs = spec_leaves(cohort_param_specs(params_template, mesh))
            shards = ShardLayout(layout, specs, sizes["model"])
            model_group = mesh["model"].get_group()
            group = mesh["clients"].get_group()
        else:
            group = mesh.get_group()
    cohort = make_cohort_round(loss_fn, layout, algo, eta_l, eta_g,
                               group=group, model_group=model_group,
                               shards=shards)
    row_split = model_group is not None and cohort.tp is None

    silos: Optional[int] = None

    def round_step(params, delta_prev, batches):
        nonlocal silos
        if silos is None:
            k = tree_leaves(batches)[0].shape[0]
            if row_split:
                # the model ranks' trained shares partition each client
                # slice's rows: K is every rank's share summed
                t = torch.tensor([k], device=params.device)
                dist.all_reduce(t, group=model_group)
                dist.all_reduce(t, group=group)
                silos = int(t)
            else:
                silos = k * (1 if group is None
                             else dist.get_world_size(group))
        ids = torch.arange(silos, dtype=torch.int32, device=params.device)
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
