"""Layer primitives (counterpart of repro/models/layers.py): GroupNorm for
the vision models; linear, norms, MLPs, RoPE and the encoder's
sinusoidal positions for the decoders.

Parameters are plain dicts of tensors in the reference's layouts (a
linear weight is (d_in, d_out), applied as ``x @ w``), so the reference's
params carry across leaf for leaf. Initializers take an ``rng`` of one of
three kinds:

  * a ``torch.Generator``: draws on its device, in call order, with the
    reference's distributions (not its numbers) — the serving path, where
    numpy draws of 3-7 B parameters would take minutes;
  * a ``core.jax_prng`` key: the reference's own numbers, drawn on the
    CPU in numpy and split along the reference's key tree — training and
    the examples;
  * ``"meta"``: tensors on the meta device, shapes and dtypes only
    (``launch/steps.params_spec``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import jax_prng
from repro_torch.sharding import tensor_parallel as tpm

META = "meta"         # the shapes-only rng


def init_group_norm(groups: int, channels: int, dtype=torch.float32):
    return {"scale": torch.ones(channels, dtype=dtype),
            "bias": torch.zeros(channels, dtype=dtype)}


def group_norm(p, x: torch.Tensor, groups: int, eps: float = 1e-5
               ) -> torch.Tensor:
    """x (B, C, H, W) — the NCHW view the vision models work in; the
    reference normalizes its NHWC array over the same (H, W, C/groups)
    sets, with the biased variance, then applies per-channel scale and
    bias."""
    return F.group_norm(x.float(), groups, p["scale"], p["bias"],
                        eps).to(x.dtype)


# ---------------- rng ----------------

def rng_device(rng) -> torch.device:
    if isinstance(rng, torch.Generator):
        return rng.device
    return torch.device(META if isinstance(rng, str) else "cpu")


def split_rng(rng, num: int):
    """``jax.random.split`` of a key; a generator (or "meta") is handed
    on ``num`` times: it draws in call order."""
    if isinstance(rng, (torch.Generator, str)):
        return [rng] * num
    return list(jax_prng.split(rng, num))


def fold_rng(rng, data: int):
    """``jax.random.fold_in`` of a key; a generator is handed on."""
    if isinstance(rng, (torch.Generator, str)):
        return rng
    return jax_prng.fold_in(rng, data)


def normal(rng, shape, *, mul: Optional[float] = None,
           div: Optional[float] = None) -> torch.Tensor:
    """f32 N(0, 1) of ``shape`` times ``mul`` or over ``div``. From a key,
    the reference's ``jax.random.normal(key, shape) * mul`` (or ``/ div``)
    in f32, the arithmetic in numpy as XLA rounds it."""
    shape = tuple(shape)
    if isinstance(rng, torch.Generator):
        # scaled in place: a full-width expert stack is tens of GB
        x = torch.randn(shape, generator=rng, device=rng.device)
        if mul is not None:
            x.mul_(mul)
        return x.div_(div) if div is not None else x
    if isinstance(rng, str):
        return torch.empty(shape, dtype=torch.float32, device=META)
    x = jax_prng.normal(rng, shape)
    if mul is not None:
        x = x * np.float32(mul)
    if div is not None:
        x = x / np.float32(div)
    return torch.from_numpy(x)


# ---------------- linear ----------------

def _dense_init(rng, shape, dtype, scale: Optional[float] = None
                ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return normal(rng, shape, mul=scale).to(dtype)


def init_linear(rng, d_in: int, d_out: int, dtype, bias: bool = False,
                scale: Optional[float] = None):
    p = {"w": _dense_init(rng, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=rng_device(rng))
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------- norms ----------------

def init_norm(kind: str, d: int, dtype, device=None):
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis; statistics in f32, the
    result cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    return F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


# ---------------- MLP ----------------

def init_mlp(rng, kind: str, d_model: int, d_ff: int, dtype,
             bias: bool = False):
    ks = split_rng(rng, 3)
    if kind == "swiglu":
        return {"gate": init_linear(ks[0], d_model, d_ff, dtype, bias),
                "up": init_linear(ks[1], d_model, d_ff, dtype, bias),
                "down": init_linear(ks[2], d_ff, d_model, dtype, bias)}
    return {"up": init_linear(ks[0], d_model, d_ff, dtype, bias),
            "down": init_linear(ks[1], d_ff, d_model, dtype, bias)}


def row_parallel(p, h: torch.Tensor, tp=None) -> torch.Tensor:
    """``linear(p, h)`` of a row-parallel layer: with a tensor-parallel
    context ``tp`` (sharding/tensor_parallel.py) ``p["w"]`` holds this
    rank's rows and ``h`` its columns, the product is summed over the
    model group, and the (whole) bias is added after the sum."""
    y = tpm.reduce_from_region(h @ p["w"], tp)
    if "b" in p:
        y = y + p["b"]
    return y


def apply_mlp(kind: str, p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The MLP; with ``tp`` Megatron's: ``gate``/``up`` column-parallel
    (this rank's slice of d_ff, after a copy-to-region of x), ``down``
    row-parallel (``row_parallel``)."""
    x = tpm.copy_to_region(x, tp)
    if kind == "swiglu":
        return row_parallel(p["down"], F.silu(linear(p["gate"], x))
                            * linear(p["up"], x), tp)
    h = linear(p["up"], x)
    if kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return row_parallel(p["down"], h, tp)


# ---------------- RoPE ----------------

def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (..., S) int -> cos, sin (..., S, head_dim/2) f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2). The half-split
    form (x1 = x[..., :D/2], x2 = x[..., D/2:]), computed in f32 and cast
    back to x's dtype."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos_ - xf2 * sin_, xf2 * cos_ + xf1 * sin_],
                     dim=-1).to(x.dtype)


# ---------------- sinusoidal positions ----------------

@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return lib


@functools.lru_cache(maxsize=8)
def _sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    # 10000 ** (dim / d) in f64, rounded once to f32: libm's powf, which
    # XLA's CPU backend calls, gives these bits on these exponents
    freq = (10000.0 ** (dim / np.float32(d_model)).astype(np.float64)
            ).astype(np.float32)
    ang = (pos / freq).ravel()
    lib = _libm()
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.fromiter(map(lib.sinf, ang), np.float32,
                              ang.size).reshape(max_len, -1)
    pe[:, 1::2] = np.fromiter(map(lib.cosf, ang), np.float32,
                              ang.size).reshape(max_len, -1)
    pe.flags.writeable = False
    return pe


def sinusoidal_positions(max_len: int, d_model: int) -> torch.Tensor:
    """(max_len, d_model) f32 on the CPU: sin in the even columns, cos in
    the odd ones, of pos / 10000^(2i / d_model) — the encoder's table,
    interleaved (the decoder's own is concatenated, models/encdec.py).
    Bit for bit the reference's CPU table: the angle in f32 and the sines
    by the C library's sinf and cosf, as XLA's CPU backend computes them;
    built once per shape on the host."""
    return torch.from_numpy(_sinusoid_table(max_len, d_model).copy())
