"""Plain PyTorch version of the selective-scan kernel (counterpart of
repro/kernels/ssm_scan/ref.py): the sequential recurrence over time,
state (B, D_in, N) in f32,

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t
    y_t = sum_n c_t[n] * h_t[:, n] + d_skip * u_t

starting from ``h0`` (zeros when None), with the kernel's rounding step
for step (the sum over n as its pairwise tree). The kernel's fused
inputs are the Mamba mixer's own eager ops around the scan: dt = dt +
``dt_bias``, then ``softplus`` of it (``dt_softplus``), and y * silu(``z``)
in u's dtype. It keeps one (B, D_in, N) state
and a few step-sized temporaries, never the (B, S, D_in, N) tensors of
the reference model's associative scan: at Falcon-Mamba-7B's width those
are 4.3 GB each in f32.

On meta tensors (the dry-run, launch/dryrun.py) the walk is one counted
op (``_CountedScan``, with a meta backward): it returns meta outputs
and records (kernels.meta_cost) exactly what walking the S steps, and
their backward, would have counted (roofline/analysis.OpCounter). Both
are polynomials in S — the forward linear, the backward quadratic (each
step's slice of b, c, dt and u takes a gradient the size of the whole
input) — so the record is the walk's own count at S = 1, 2 and 3,
extrapolated; a step of thousands of time steps costs three tiny walks,
not thousands of Python iterations a layer."""
from __future__ import annotations

import concurrent.futures
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    exact for every x (torch's softplus returns x above its threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 dt_bias: Optional[torch.Tensor] = None,
                 dt_softplus: bool = False,
                 z: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B, S, D_in) f32 or bf16, dt (B, S, D_in) f32, b/c (B, S, N)
    f32, a (D_in, N) f32 (already negative), d_skip (D_in,) f32, h0
    (B, D_in, N) f32 or None, dt_bias (D_in,) f32 or None, z (B, S, D_in)
    in u's dtype or None -> (y (B, S, D_in) in u's dtype — y * silu(z)
    when z is given — and h_final (B, D_in, N) f32)."""
    if u.device.type == "meta":
        need = tuple(t is not None and t.requires_grad
                     and torch.is_grad_enabled()
                     for t in (u, dt, b, c, a, d_skip, h0, dt_bias, z))
        spec = (tuple(u.shape), b.shape[-1], u.dtype,
                None if z is None else z.dtype, h0 is not None,
                dt_bias is not None, bool(dt_softplus), need)
        return _CountedScan.apply(spec, u, dt, b, c, a, d_skip, h0, dt_bias,
                                  z)
    return _walk(u, dt, b, c, a, d_skip, h0, dt_bias, dt_softplus, z)


def _walk(u, dt, b, c, a, d_skip, h0, dt_bias, dt_softplus, z):
    """The plain recurrence (``ssm_scan_ref``)."""
    if dt_bias is not None:
        dt = dt + dt_bias
    if dt_softplus:
        dt = softplus(dt)
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    uf = u.float()
    dtf = dt.float()
    h = (torch.zeros((bsz, d_in, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float().clone())
    ys = []
    for t in range(s):
        dt_t, u_t = dtf[:, t], uf[:, t]                      # (B, D_in)
        decay = torch.exp(dt_t[..., None] * a)               # (B, D_in, N)
        h = h * decay + (dt_t * u_t)[..., None] * b[:, t, None, :]
        ys.append(_sum_states(h * c[:, t, None, :]) + d_skip * u_t)
    # stacked, not written into a preallocated buffer: the training route
    # runs this under torch.func.vmap and autograd, which refuse an
    # in-place write of a batched value into an unbatched buffer
    y = torch.stack(ys, dim=1).to(u.dtype)
    if z is not None:
        y = y * F.silu(z)
    return y, h


def _sum_states(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree, zero-padded to a power of
    two (the kernel's order): the same f32 roundings on every device."""
    n = x.shape[-1]
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def _inputs_at(spec, s: int):
    """Meta inputs of ``spec`` (``ssm_scan_ref``'s) at S = s, each
    requiring grad where the spec's does."""
    (bsz, _, d_in), n, udt, zdt, has_h0, has_bias, _, need = spec
    f32 = torch.float32
    shapes = ((bsz, s, d_in, udt), (bsz, s, d_in, f32), (bsz, s, n, f32),
              (bsz, s, n, f32), (d_in, n, f32), (d_in, f32),
              (bsz, d_in, n, f32) if has_h0 else None,
              (d_in, f32) if has_bias else None,
              (bsz, s, d_in, zdt) if zdt is not None else None)
    return [None if sh is None else
            torch.empty(sh[:-1], dtype=sh[-1], device="meta")
            .requires_grad_(bool(g)) for sh, g in zip(shapes, need)]


@functools.lru_cache(maxsize=256)
def _walk_count(spec, s: int, grad_h: bool):
    """((FLOPs, bytes) of the forward walk, of its backward) at S = s,
    counted by roofline/analysis.OpCounter in a thread of its own: the
    caller's dispatch modes (an outer counter), grad mode and saved-tensor
    hooks (a checkpointed layer's) are the calling thread's, and none of
    them may see this walk."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(_count_walk, spec, s, grad_h).result()


def _count_walk(spec, s, grad_h):
    from repro_torch.roofline.analysis import OpCounter
    softplus_on = spec[6]
    with torch.enable_grad():
        ins = _inputs_at(spec, s)
        with OpCounter() as fwd:
            y, h = _walk(*ins[:7], ins[7], softplus_on, ins[8])
        wrt = [t for t in ins if t is not None and t.requires_grad]
        bwd = None
        if wrt:
            outs, seeds = [y], [torch.empty_like(y)]
            if grad_h:
                outs.append(h)
                seeds.append(torch.empty_like(h))
            with OpCounter() as bwd:
                torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
    one = lambda c: (0, 0) if c is None else (c.count.flops, c.count.bytes)
    return one(fwd), one(bwd)


def walk_count(spec, grad_h: bool = False):
    """((FLOPs, bytes) forward, backward) that walking ``spec``'s S steps
    counts: quadratic in S, from the walks at S = 1, 2, 3."""
    s = spec[0][1]
    c1, c2, c3 = (_walk_count(spec, k, grad_h) for k in (1, 2, 3))

    def at(j, i):
        y1, y2, y3 = c1[j][i], c2[j][i], c3[j][i]
        return (y1 + (s - 1) * (y2 - y1)
                + (s - 1) * (s - 2) // 2 * (y3 - 2 * y2 + y1))
    return tuple(tuple(at(j, i) for i in (0, 1)) for j in (0, 1))


class _CountedScan(torch.autograd.Function):
    """``ssm_scan_ref`` on meta tensors: one op whose forward and
    backward record the walk's count (module docstring)."""

    @staticmethod
    def forward(ctx, spec, u, dt, b, c, a, d_skip, h0, dt_bias, z):
        from repro_torch.kernels import meta_cost
        ctx.spec = spec
        ctx.like = [None if t is None else (t.shape, t.dtype)
                    for t in (u, dt, b, c, a, d_skip, h0, dt_bias, z)]
        ctx.set_materialize_grads(False)
        meta_cost("ssm_scan_ref", *walk_count(spec)[0])
        bsz, _, d_in = u.shape
        return (torch.empty(u.shape, dtype=u.dtype, device="meta"),
                torch.empty((bsz, d_in, b.shape[-1]), dtype=torch.float32,
                            device="meta"))

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.kernels import meta_cost
        if gy is None:
            raise ValueError("ssm_scan_ref on meta: a backward from "
                             "h_final alone is not counted")
        meta_cost("ssm_scan_ref backward",
                  *walk_count(ctx.spec, gh is not None)[1])
        grads = [torch.empty(like[0], dtype=like[1], device="meta")
                 if like is not None and ctx.needs_input_grad[i + 1]
                 else None for i, like in enumerate(ctx.like)]
        return (None, *grads)
