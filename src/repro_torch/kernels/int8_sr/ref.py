"""Plain PyTorch version of ``int8_sr_quantize`` (csrc/int8_sr.cu): the
same threefry2x32 draw and the same f32 steps, in int64 tensor ops masked
to 32 bits. The wrapper (ops.py) calls it for CPU tensors; chip_smoke.py
holds the kernel against it, bit for bit, on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.feddpc_project.ref import column_leaves

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_ref(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 (20 rounds) on int64 tensors holding uint32 values;
    ``k0`` and ``k1`` broadcast against the counters. Returns the two
    output words (int64, in [0, 2**32))."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def draw_bits_ref(k0, k1, n: torch.Tensor, size, partitionable: bool):
    """The 32 random bits of elements ``n`` of a draw of ``size`` elements
    (jax.random.bits' two counter layouts; see core/jax_prng.py)."""
    if partitionable:
        y0, y1 = threefry2x32_ref(k0, k1, n >> 32, n & _MASK)
        return y0 ^ y1
    h = (size + 1) // 2
    first = n < h
    x0 = torch.where(first, n, n - h)
    x1 = torch.where(first, torch.where(n + h < size, n + h,
                                        torch.zeros_like(n)), n)
    y0, y1 = threefry2x32_ref(k0, k1, x0, x1)
    return torch.where(first, y0, y1)


def bits_to_unit_ref(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1), as jax.random.uniform builds it."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def int8_sr_quantize_ref(x: torch.Tensor, scale: torch.Tensor,
                         leaf_offsets: torch.Tensor, keys: torch.Tensor,
                         partitionable: bool = True, row0: int = 0,
                         rows_total: int = None,
                         leaf_blocks: torch.Tensor = None) -> torch.Tensor:
    """x (K, N) f32, scale (K, L) f32, leaf_offsets (L+1,) int64, keys
    (L, 2) int64 uint32 words, on x's device -> q (K, N) int8:
    int8(clip(floor(x / scale_leaf + u), -127, 127)) with NaN -> 0, u the
    uniform of the leaf's key at counter (row0 + k) * numel_leaf + j of a
    draw of rows_total * numel_leaf elements (the kernel's block
    arguments: ``leaf_blocks`` (L, 4) per leaf (numel, inner, stride,
    base), the whole leaf's element count and j = (p // inner) * stride
    + base + p % inner for the leaf's p-th column; None: the block's own
    leaves, j = p)."""
    k, n = x.shape
    dev = x.device
    offsets = leaf_offsets.to(dev)
    counts = offsets[1:] - offsets[:-1]
    leaf = column_leaves(offsets, n, dev)
    j = torch.arange(n, device=dev) - offsets[leaf]
    if leaf_blocks is None:
        numel = counts[leaf]
    else:
        numel, inner, stride, base = leaf_blocks.to(dev)[leaf].unbind(1)
        j = torch.div(j, inner, rounding_mode="floor") * stride + base \
            + j % inner
    rows_total = k if rows_total is None else int(rows_total)
    idx = (int(row0) + torch.arange(k, device=dev))[:, None] * numel + j
    keys = keys.to(dev)
    bits = draw_bits_ref(keys[leaf, 0], keys[leaf, 1], idx,
                         rows_total * numel, partitionable)
    u = bits_to_unit_ref(bits)
    del bits, idx
    y = x.float() / scale[:, leaf]
    v = torch.clamp(torch.floor(y + u), -127.0, 127.0)
    return torch.where(torch.isnan(v), torch.zeros_like(v), v
                       ).to(torch.int8)
