"""Wrapper for the selective-scan kernel (csrc/ssm_scan.cu), with the
contract of repro/kernels/ssm_scan/ops.py plus the optional initial state
that a prefill continuation and a decode step carry in: u (B, S, D_in)
f32 or bf16, dt (B, S, D_in), b/c (B, S, N), a (D_in, N) (already
negative), d_skip (D_in,) and h0 (B, D_in, N) or None, all f32 ->
(y (B, S, D_in) in u's dtype, h_final (B, D_in, N) f32).

Two keyword inputs fold the Mamba mixer's prologue and gate into the same
launch: ``dt_bias`` (D_in,) f32 is added to dt, and ``dt_softplus=True``
takes softplus of the sum (dt is then x_proj's raw dt rows times W_dt);
``z`` (B, S, D_in) in u's dtype makes the output y * silu(z). Without
them the call computes what it always did.

``ssm_scan`` checks shapes, dtypes and devices, refuses (with a
ValueError naming the training route) any input that requires grad or is
wrapped by a ``torch.func`` transform — the kernel has no backward, and
the reference's training never calls its scan kernel — then

  * for CUDA tensors makes u, dt and the small inputs contiguous (b, c and
    z are read in place, at their batch and step strides, when their last
    dim is contiguous: the model's slices of one projection), launches
    the kernel on the current stream (or raises — there is no fallback)
    and adds one to its ``launches`` count, only there;
  * for CPU tensors calls the plain version, ``ref.ssm_scan_ref``;
  * for meta tensors returns meta outputs and records one launch's cost
    (``meta_work``; kernels.meta_cost), for the dry-run.

There is no padding path: the kernel masks ragged S and D_in itself. It
is compiled at first use with ``nvcc`` into a shared library with a plain
C interface, loaded with ``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, meta_cost, nbytes, refuse_training
from repro_torch.kernels.ssm_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
LIBRARY = "ssm_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # u's dtype -> code
MAX_STATE = 32            # the kernel's largest N (csrc: kMaxState)
TRAINING_ROUTE = ("the plain scan (models.transformer.loss_fn, or "
                  "ssm.mamba_forward(impl='reference'))")

_lib = None           # the loaded library, once per process


def build() -> Path:
    """Compile the kernel unless this source's library exists."""
    return _build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssm_scan_fwd.argtypes = [vp] * 11 + [i32] * 6 + [i64] * 6 + [vp]
        lib.ssm_scan_fwd.restype = i32
        lib.ssm_scan_error_string.argtypes = [i32]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(u, dt, b, c, a, d_skip, h0, dt_bias, z):
    name = "ssm_scan"
    if u.dim() != 3:
        raise ValueError(f"{name}: u must be (B, S, D_in), got "
                         f"{tuple(u.shape)}")
    bsz, s, d_in = u.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = {"dt": (dt, (bsz, s, d_in)), "b": (b, (bsz, s, n)),
            "c": (c, (bsz, s, n)), "a": (a, (d_in, n)),
            "d_skip": (d_skip, (d_in,))}
    if h0 is not None:
        want["h0"] = (h0, (bsz, d_in, n))
    if dt_bias is not None:
        want["dt_bias"] = (dt_bias, (d_in,))
    shapes = dict(want)
    if z is not None:
        shapes["z"] = (z, (bsz, s, d_in))
    for key, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape} for u "
                             f"{tuple(u.shape)}, got {tuple(t.shape)}")
    if min(bsz, s, d_in, n) < 1:
        raise ValueError(f"{name}: empty input u {tuple(u.shape)}, b "
                         f"{tuple(b.shape)}")
    if u.dtype not in DTYPES:
        raise TypeError(f"{name}: u must be one of {list(DTYPES)}, got "
                        f"{u.dtype}")
    if z is not None and z.dtype != u.dtype:
        raise TypeError(f"{name}: z must be u's dtype {u.dtype}, got "
                        f"{z.dtype}")
    for key, (t, _) in want.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
    if u.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: tensors on {u.device} are not supported")
    for key, (t, _) in shapes.items():
        if t.device != u.device:
            raise ValueError(f"{name}: {key} on {t.device}, u on {u.device}")


def _rows(t):
    """t (B, S, X) with a contiguous last dim, and its batch and step
    strides in elements."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def meta_work(u, dt, b, c, a, d_skip, h0=None, dt_bias=None,
              dt_softplus=False, z=None) -> Tuple[int, int]:
    """(f32 FLOPs, bytes) of one launch, the formula behind the kernel's
    bound: each input read once, y and h_final written once; per (batch,
    step, channel, state) dt*a, h*decay + du*b and acc + h*c (6 FLOPs),
    per (batch, step, channel) du, d*u and the sum (3), with dt's bias
    and softplus 3 more and with the gate 3 more (its exponentials and
    logarithms, on the SFU, are not FLOPs)."""
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    elems = bsz * s * d_in
    flops = 6 * elems * n + 3 * elems
    if dt_bias is not None or dt_softplus:
        flops += 3 * elems
    if z is not None:
        flops += 3 * elems
    moved = (2 * nbytes(u) + nbytes(dt, b, c, a, d_skip, h0, dt_bias, z)
             + 4 * bsz * d_in * n)
    return flops, moved


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             dt_bias: Optional[torch.Tensor] = None,
             dt_softplus: bool = False,
             z: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D_in) in u's dtype, h_final (B, D_in, N) f32) of the
    recurrence h_t = exp(dt_t a) h_{t-1} + dt_t u_t b_t, y_t = c_t . h_t
    + d_skip u_t, from h0 (zeros when None); dt is first dt + dt_bias
    (when given), then softplus of it (when ``dt_softplus``), and y is
    y * silu(z) (when ``z`` is given)."""
    _check(u, dt, b, c, a, d_skip, h0, dt_bias, z)
    refuse_training("ssm_scan", TRAINING_ROUTE, u, dt, b, c, a, d_skip, h0,
                    dt_bias, z)
    if u.device.type == "cpu":
        return ref.ssm_scan_ref(u, dt, b, c, a, d_skip, h0, dt_bias=dt_bias,
                                dt_softplus=dt_softplus, z=z)
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    if n > MAX_STATE or bsz > 65535:
        raise ValueError(f"ssm_scan: the kernel takes N up to {MAX_STATE} "
                         f"and B up to 65535, got N = {n}, B = {bsz}")
    if u.device.type == "meta":
        meta_cost("ssm_scan", *meta_work(u, dt, b, c, a, d_skip, h0,
                                         dt_bias, dt_softplus, z))
        return (torch.empty_like(u),
                torch.empty((bsz, d_in, n), dtype=torch.float32,
                            device=u.device))
    u, dt, a, d_skip = (t.contiguous() for t in (u, dt, a, d_skip))
    h0, dt_bias = (None if t is None else t.contiguous()
                   for t in (h0, dt_bias))
    b, b_sb, b_st = _rows(b)
    c, c_sb, c_st = _rows(c)
    z, z_sb, z_st = (None, 0, 0) if z is None else _rows(z)
    y = torch.empty_like(u)
    h = torch.empty((bsz, d_in, n), dtype=torch.float32, device=u.device)
    lib = _load()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(u.device):
        err = lib.ssm_scan_fwd(
            ptr(u), ptr(dt), ptr(b), ptr(c), ptr(a), ptr(d_skip), ptr(h0),
            ptr(dt_bias), ptr(z), ptr(y), ptr(h), DTYPES[u.dtype], bsz, s,
            d_in, n, int(bool(dt_softplus)), b_sb, b_st, c_sb, c_st, z_sb,
            z_st, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err} "
                           f"({msg})")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0


def reset_launches():
    ssm_scan.launches = 0
