"""Wrapper for the int8_sr encode kernel (csrc/int8_sr.cu).

``int8_sr_quantize(x, scale, leaf_offsets, keys)`` checks device, dtype,
shape and contiguity, then

  * for CUDA tensors launches the kernel on the current stream (or raises
    — there is no fallback) and adds one to ``int8_sr_quantize.launches``,
    only there;
  * for CPU tensors calls the plain version in ``ref.py``.

The kernel is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import jax_prng
from repro_torch.kernels import _build
from repro_torch.kernels.feddpc_project.ops import device_offsets
from repro_torch.kernels.int8_sr import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_sr.cu"
LIBRARY = "int8_sr"

_lib = None           # the loaded library, once per process


def build() -> Path:
    """Compile the kernel unless this source's library exists."""
    return _build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.int8_sr_quantize.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64,
                                         cint, cint, i64, i64, vp]
        lib.int8_sr_quantize.restype = cint
        lib.int8_sr_error_string.argtypes = [cint]
        lib.int8_sr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, scale, leaf_offsets, keys, row0, rows_total, leaf_blocks):
    name = "int8_sr_quantize"
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: x must be (K, N) with K, N >= 1, got "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {x.device} are not supported")
    k, n = x.shape
    nleaves = leaf_offsets.numel() - 1
    for what, t, shape in (("x", x, (k, n)), ("scale", scale, (k, nleaves))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{x.device}")
    if (leaf_offsets.device.type != "cpu"
            or leaf_offsets.dtype != torch.int64 or leaf_offsets.dim() != 1
            or nleaves < 1 or int(leaf_offsets[0]) != 0
            or int(leaf_offsets[-1]) != n
            or not bool((leaf_offsets[1:] > leaf_offsets[:-1]).all())):
        raise ValueError(f"{name}: leaf_offsets must be a CPU int64 tensor "
                         f"running from 0 to N={n}, strictly increasing")
    if keys.shape != (nleaves, 2) or keys.dtype != np.uint32:
        raise ValueError(f"{name}: keys must be uint32 ({nleaves}, 2), got "
                         f"{keys.dtype} {keys.shape}")
    if k > 65535:
        raise ValueError(f"{name}: K={k} rows; the kernel takes at most "
                         "65535")
    if not 0 <= row0 <= rows_total - k:
        raise ValueError(f"{name}: rows [{row0}, {row0 + k}) outside the "
                         f"stack's {rows_total}")
    if leaf_blocks is None:
        return
    widths = leaf_offsets[1:] - leaf_offsets[:-1]
    ok = (leaf_blocks.device.type == "cpu"
          and leaf_blocks.dtype == torch.int64
          and tuple(leaf_blocks.shape) == (nleaves, 4))
    if ok:
        numel, inner, stride, base = leaf_blocks.unbind(1)
        # the block's elements tile whole rows of `inner` and the last
        # one lies inside the leaf
        ok = bool(((inner >= 1) & (widths % inner == 0) & (base >= 0)
                   & (stride >= inner)
                   & ((widths // inner - 1) * stride + base + inner
                      <= numel)).all())
    if not ok:
        raise ValueError(f"{name}: leaf_blocks must be a CPU int64 "
                         f"({nleaves}, 4) tensor of (numel, inner, stride, "
                         "base) per leaf, each block inside its leaf")


def int8_sr_quantize(x: torch.Tensor, scale: torch.Tensor,
                     leaf_offsets: torch.Tensor, keys: np.ndarray,
                     partitionable: bool = None, *, row0: int = 0,
                     rows_total: int = None,
                     leaf_blocks: torch.Tensor = None) -> torch.Tensor:
    """x (K, N) f32 on the device, scale (K, L) f32 (one symmetric scale
    per client and leaf, zero ranges already 1), leaf_offsets a CPU int64
    (L+1,) tensor, keys a numpy (L, 2) uint32 array of per-leaf PRNG keys
    -> q (K, N) int8, the int8_sr codes: floor(x / scale + u) clipped to
    [-127, 127], NaN -> 0, with u the reference's uniform of the leaf's key
    at counter k * numel_leaf + j. ``partitionable`` picks JAX's counter
    layout (default: core.jax_prng.PARTITIONABLE).

    A rank's block of a larger stack draws that stack's noise: x holds
    rows ``row0``.. of ``rows_total`` (default K), and on a model shard
    ``leaf_blocks`` (L, 4) CPU int64 gives each leaf's whole element
    count and the strided slice the shard holds of it (numel, inner,
    stride, base: the shard's p-th element of the leaf is element
    (p // inner) * stride + base + p % inner of the whole leaf;
    sharding/layout.ShardLayout.leaf_blocks)."""
    keys = np.asarray(keys)
    rows_total = x.shape[0] if rows_total is None else int(rows_total)
    row0 = int(row0)
    _check(x, scale, leaf_offsets, keys, row0, rows_total, leaf_blocks)
    part = (jax_prng.PARTITIONABLE if partitionable is None
            else partitionable)
    if x.device.type == "cpu":
        return ref.int8_sr_quantize_ref(
            x, scale, leaf_offsets,
            torch.from_numpy(keys.astype(np.int64)), part, row0, rows_total,
            leaf_blocks)
    lib = _load()
    k, n = x.shape
    q = torch.empty((k, n), dtype=torch.int8, device=x.device)
    # the layout's device copies, cached with the dequant folds'
    offs = device_offsets(leaf_offsets, x.device)
    blocks = (None if leaf_blocks is None
              else device_offsets(leaf_blocks.reshape(-1), x.device))
    keys_dev = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32)
                                ).to(x.device, non_blocking=True)
    err = lib.int8_sr_quantize(
        x.data_ptr(), scale.data_ptr(), offs.data_ptr(), keys_dev.data_ptr(),
        None if blocks is None else blocks.data_ptr(), q.data_ptr(), k, n,
        leaf_offsets.numel() - 1, int(bool(part)), row0, rows_total,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_sr_quantize launch failed: CUDA error "
                           f"{err} ({lib.int8_sr_error_string(err).decode()})")
    int8_sr_quantize.launches += 1
    return q


int8_sr_quantize.launches = 0
KERNELS = (int8_sr_quantize,)


def reset_launches():
    int8_sr_quantize.launches = 0
