"""The shipped codecs on the flat layout: identity, bf16, int8 and
int8_sym (counterpart of repro/codec/codecs.py).

Each leaf segment of the (K, N) stack encodes with the reference's f32
expressions in the reference's order (codecs.py ``_encode_leaf``):
per client, min/max (or max|x|) over the leaf; ``scale <= 0 -> 1`` with
NaN and Inf kept; ``(x - zero) / scale``; ``torch.round`` (half to even,
as ``jnp.round``); clip to [-127, 127]; cast. The reductions run per
leaf; the element-wise steps run once over the whole stack with the
per-leaf scalars repeated over their columns — the same operations on
the same values, so the codes are the reference's. A NaN code (a leaf
holding NaN or Inf) becomes 0 before the cast, as XLA converts NaN to an
integer; torch's cast of NaN is undefined.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.codec.base import DeltaCodec, register_codec
from repro_torch.kernels.feddpc_project.ref import dequant_ref


@register_codec("identity")
class IdentityCodec(DeltaCodec):
    """Pass-through: encode and decode return the SAME tensor, so
    codec=identity rounds are bitwise the rounds with no codec."""

    name = "identity"
    lossy = False

    def encode_cohort(self, stacked, leaf_offsets):
        return stacked

    def decode_cohort(self, payload, leaf_offsets):
        return payload

    def client_bytes(self, numels):
        return 4 * int(sum(numels))


def _payload_bytes(numels: Sequence[int], itemsize: int) -> int:
    """q bytes + one (scale, zero) f32 pair per leaf."""
    return int(sum(numels)) * itemsize + 8 * len(numels)


def _per_column(v: torch.Tensor, leaf_offsets: torch.Tensor, n: int):
    """(K, L) per-leaf scalars -> (K, N), each repeated over its leaf."""
    counts = (leaf_offsets[1:] - leaf_offsets[:-1]).to(v.device)
    return torch.repeat_interleave(v, counts, dim=1, output_size=n)


class _QuantCodec(DeltaCodec):
    """Shared plumbing: per-leaf scalars, then one element-wise pass."""

    _itemsize = 1

    def _leaf_scalars(self, x, leaf_offsets):
        raise NotImplementedError

    def _quantize(self, y):
        raise NotImplementedError

    def encode_cohort(self, stacked, leaf_offsets):
        x = stacked.float()
        n = x.shape[1]
        scale, zero = self._leaf_scalars(x, leaf_offsets)
        y = ((x - _per_column(zero, leaf_offsets, n))
             / _per_column(scale, leaf_offsets, n))
        return {"q": self._quantize(y), "scale": scale, "zero": zero}

    def decode_cohort(self, payload, leaf_offsets):
        return dequant_ref(payload["q"], payload["scale"], payload["zero"],
                           leaf_offsets)

    def client_bytes(self, numels):
        return _payload_bytes(numels, self._itemsize)


@register_codec("bf16")
class BF16Codec(_QuantCodec):
    """bfloat16 round-to-nearest-even with unit scales: half the uplink
    bytes, ~2^-8 relative error; the bf16 -> f32 decode is exact."""

    name = "bf16"
    lossy = True
    _itemsize = 2

    def encode_cohort(self, stacked, leaf_offsets):
        k, nleaves = stacked.shape[0], leaf_offsets.numel() - 1
        ones = torch.ones((k, nleaves), dtype=torch.float32,
                          device=stacked.device)
        return {"q": stacked.float().to(torch.bfloat16), "scale": ones,
                "zero": torch.zeros_like(ones)}


@register_codec("int8")
class Int8Codec(_QuantCodec):
    """int8 with per-leaf, per-client scales: affine by default
    (scale = (max - min) / 254, zero = min + 127 scale, codes in
    [-127, 127]); ``symmetric=True`` drops the zero-point
    (scale = max|x| / 127, zero = 0)."""

    lossy = True
    _itemsize = 1

    def __init__(self, symmetric: bool = False):
        self.symmetric = symmetric
        self.name = "int8_sym" if symmetric else "int8"

    def _leaf_scalars(self, x, leaf_offsets):
        sizes = (leaf_offsets[1:] - leaf_offsets[:-1]).tolist()
        if self.symmetric:
            amax = torch.stack([torch.amax(seg, dim=1) for seg in
                                torch.split(torch.abs(x), sizes, dim=1)], 1)
            scale = amax / 127.0
            zero = torch.zeros_like(scale)
        else:
            segs = torch.split(x, sizes, dim=1)
            mn = torch.stack([torch.amin(seg, dim=1) for seg in segs], 1)
            mx = torch.stack([torch.amax(seg, dim=1) for seg in segs], 1)
            scale = (mx - mn) / 254.0
            zero = mn + 127.0 * scale
        # zero ranges -> unit scale (codes all 0, decode exact); NaN and
        # Inf scales stay, so non-finite rows survive the decode
        scale = torch.where(scale <= 0.0, torch.ones_like(scale), scale)
        return scale, zero

    def _quantize(self, y):
        y = torch.clamp(torch.round(y), -127.0, 127.0)
        return torch.where(torch.isnan(y), torch.zeros_like(y), y
                           ).to(torch.int8)

    def config_dict(self):
        return {"name": self.name, "symmetric": self.symmetric}


register_codec("int8_sym")(lambda: Int8Codec(symmetric=True))
