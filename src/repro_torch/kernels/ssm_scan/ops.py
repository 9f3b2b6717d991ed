"""Wrapper for the selective-scan kernel (csrc/ssm_scan.cu), with the
contract of repro/kernels/ssm_scan/ops.py plus the optional initial state
that a prefill continuation and a decode step carry in: u (B, S, D_in)
f32 or bf16, dt (B, S, D_in), b/c (B, S, N), a (D_in, N) (already
negative), d_skip (D_in,) and h0 (B, D_in, N) or None, all f32 ->
(y (B, S, D_in) in u's dtype, h_final (B, D_in, N) f32).

``ssm_scan`` checks shapes, dtypes and devices, then

  * for CUDA tensors makes the inputs contiguous (b and c are strided
    slices of x_proj's output in the model), launches the kernel on the
    current stream (or raises — there is no fallback) and adds one to its
    ``launches`` count, only there;
  * for CPU tensors calls the plain version, ``ref.ssm_scan_ref``.

There is no padding path: the kernel masks ragged S and D_in itself. It
is compiled at first use with ``nvcc`` into a shared library with a plain
C interface, loaded with ``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
LIBRARY = "ssm_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # u's dtype -> code
MAX_STATE = 32            # the kernel's largest N (csrc: kMaxState)

_lib = None           # the loaded library, once per process


def build() -> Path:
    """Compile the kernel unless this source's library exists."""
    return _build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_fwd.argtypes = [vp] * 9 + [i32] * 5 + [vp]
        lib.ssm_scan_fwd.restype = i32
        lib.ssm_scan_error_string.argtypes = [i32]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(u, dt, b, c, a, d_skip, h0):
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
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape} for u "
                             f"{tuple(u.shape)}, got {tuple(t.shape)}")
    if min(bsz, s, d_in, n) < 1:
        raise ValueError(f"{name}: empty input u {tuple(u.shape)}, b "
                         f"{tuple(b.shape)}")
    if u.dtype not in DTYPES:
        raise TypeError(f"{name}: u must be one of {list(DTYPES)}, got "
                        f"{u.dtype}")
    for key, (t, _) in want.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {u.device} are not supported")
    for key, (t, _) in want.items():
        if t.device != u.device:
            raise ValueError(f"{name}: {key} on {t.device}, u on {u.device}")


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D_in) in u's dtype, h_final (B, D_in, N) f32) of the
    recurrence h_t = exp(dt_t a) h_{t-1} + dt_t u_t b_t, y_t = c_t . h_t
    + d_skip u_t, from h0 (zeros when None)."""
    _check(u, dt, b, c, a, d_skip, h0)
    if u.device.type == "cpu":
        return ref.ssm_scan_ref(u, dt, b, c, a, d_skip, h0)
    bsz, s, d_in = u.shape
    n = b.shape[-1]
    if n > MAX_STATE or bsz > 65535:
        raise ValueError(f"ssm_scan: the kernel takes N up to {MAX_STATE} "
                         f"and B up to 65535, got N = {n}, B = {bsz}")
    u, dt, b, c, a, d_skip = (t.contiguous()
                              for t in (u, dt, b, c, a, d_skip))
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty_like(u)
    h = torch.empty((bsz, d_in, n), dtype=torch.float32, device=u.device)
    lib = _load()
    with torch.cuda.device(u.device):
        err = lib.ssm_scan_fwd(
            u.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), d_skip.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), DTYPES[u.dtype], bsz, s, d_in, n,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err} "
                           f"({msg})")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0


def reset_launches():
    ssm_scan.launches = 0
