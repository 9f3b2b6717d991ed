"""The shipped codecs on the flat layout: identity, bf16, int8, int8_sym
and int8_sr (counterpart of repro/codec/codecs.py).

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

int8_sr rounds with ``floor(y + u)`` instead, u the reference's uniform
noise: the caller passes the round's PRNG key
(``fold_in(PRNGKey(seed), round)``, core/jax_prng.py), leaf i draws from
``fold_in(key, i)``, and the quantize step runs as one kernel over the
whole stack on the card (``kernels/int8_sr``; its plain version on the
CPU), so the codes are the reference's bit for bit.

A multi-process round encodes each rank's block of the stack
(``shard``, core/round.RankShard): int8_sr draws the whole padded
cohort's noise for the block's rows, and on the model axis, where a
rank holds a shard of each leaf's columns, every leaf's min/max (or
max|x|) is taken over the whole leaf across the model ranks
(``RankShard.leaf_extrema``), so each shard quantizes with the whole
leaf's scale and the codes are those of the whole stack, restricted to
the block.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.codec.base import DeltaCodec, register_codec
from repro_torch.core import jax_prng
from repro_torch.kernels.feddpc_project.ref import dequant_ref, per_column
from repro_torch.kernels.int8_sr import ops as sr_ops


@register_codec("identity")
class IdentityCodec(DeltaCodec):
    """Pass-through: encode and decode return the SAME tensor, so
    codec=identity rounds are bitwise the rounds with no codec."""

    name = "identity"
    lossy = False

    def encode_cohort(self, stacked, leaf_offsets, key=None, shard=None):
        return stacked

    def decode_cohort(self, payload, leaf_offsets):
        return payload

    def client_bytes(self, numels):
        return 4 * int(sum(numels))


def _payload_bytes(numels: Sequence[int], itemsize: int) -> int:
    """q bytes + one (scale, zero) f32 pair per leaf."""
    return int(sum(numels)) * itemsize + 8 * len(numels)


class _QuantCodec(DeltaCodec):
    """Shared plumbing: per-leaf scalars, then one element-wise pass."""

    _itemsize = 1

    def _leaf_scalars(self, x, leaf_offsets, shard=None):
        raise NotImplementedError

    def _quantize(self, y):
        raise NotImplementedError

    def encode_cohort(self, stacked, leaf_offsets, key=None, shard=None):
        x = stacked.float()
        n = x.shape[1]
        scale, zero = self._leaf_scalars(x, leaf_offsets, shard)
        y = ((x - per_column(zero, leaf_offsets, n))
             / per_column(scale, leaf_offsets, n))
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

    def encode_cohort(self, stacked, leaf_offsets, key=None, shard=None):
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
    (scale = max|x| / 127, zero = 0); ``stochastic=True`` (symmetric only)
    rounds with floor(y + u), u ~ U[0, 1) from the caller's key —
    unbiased."""

    lossy = True
    _itemsize = 1

    def __init__(self, symmetric: bool = False, stochastic: bool = False):
        if stochastic and not symmetric:
            raise ValueError("stochastic rounding is the symmetric "
                             "option (int8_sr); affine int8 rounds to "
                             "nearest")
        self.symmetric = symmetric
        self.stochastic = stochastic
        self.name = ("int8_sr" if stochastic
                     else "int8_sym" if symmetric else "int8")

    def _leaf_scalars(self, x, leaf_offsets, shard=None):
        sizes = (leaf_offsets[1:] - leaf_offsets[:-1]).tolist()
        model = shard is not None and shard.model > 1
        if self.symmetric:
            amax = torch.stack([torch.amax(seg, dim=1) for seg in
                                torch.split(torch.abs(x), sizes, dim=1)], 1)
            if model:
                amax = shard.leaf_extrema(amax, amax)[1]
            scale = amax / 127.0
            zero = torch.zeros_like(scale)
        else:
            segs = torch.split(x, sizes, dim=1)
            mn = torch.stack([torch.amin(seg, dim=1) for seg in segs], 1)
            mx = torch.stack([torch.amax(seg, dim=1) for seg in segs], 1)
            if model:
                mn, mx = shard.leaf_extrema(mn, mx)
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

    def encode_cohort(self, stacked, leaf_offsets, key=None, shard=None):
        if not self.stochastic:
            return super().encode_cohort(stacked, leaf_offsets, shard=shard)
        if key is None:
            raise ValueError(f"codec {self.name!r} rounds stochastically "
                             "and needs an explicit PRNG key per encode "
                             "(pass key=)")
        x = stacked.float()
        scale, zero = self._leaf_scalars(x, leaf_offsets, shard)
        leaves = np.arange(leaf_offsets.numel() - 1)
        block = {}
        if shard is not None:
            # the rank's rows of the padded cohort draw the whole stack's
            # noise; a model shard's leaves keep their own keys
            block = {"row0": shard.lo, "rows_total": shard.rows}
            if shard.model > 1:
                sh, m = shard.shards, shard.mrank
                leaves = sh.leaf_ids(m)
                block["leaf_blocks"] = sh.leaf_blocks(m)
        q = sr_ops.int8_sr_quantize(
            x.contiguous(), scale, leaf_offsets,
            jax_prng.fold_in_many(key, leaves), **block)
        return {"q": q, "scale": scale, "zero": zero}

    def config_dict(self):
        # the reference's echo: a checkpoint's codec echo compares equal
        # across the two packages
        return {"name": self.name, "symmetric": self.symmetric,
                "stochastic": self.stochastic}


register_codec("int8_sym")(lambda: Int8Codec(symmetric=True))
register_codec("int8_sr")(lambda: Int8Codec(symmetric=True,
                                            stochastic=True))
