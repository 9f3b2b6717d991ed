"""DeltaCodec protocol, registry and the error-feedback residual; the
port's counterpart of repro/codec/base.py.

The wire format is flat. A (K, N) stack of client deltas (rows are flat
parameter vectors, repro_torch.bridge) encodes to

    {"q": (K, N) int8 | bf16, "scale": (K, L) f32, "zero": (K, L) f32}

with one (scale, zero) pair per client and parameter leaf. Leaf i owns
columns ``leaf_offsets[i]:leaf_offsets[i+1]`` of q
(``FlatLayout.leaf_offsets``, JAX's leaf order), so column i of scale is
the reference's scale of leaf i. Both ends know the layout; it is not
shipped. The decode, ``q * scale + zero`` per leaf, is the expression
the FedDPC dequant folds apply in their kernels
(``kernels/feddpc_project/ref.dequant_ref``).

Non-finite contract (as the reference's): a NaN/Inf delta still looks
non-finite after decode, so quantizers keep non-finite scales; only
exact-zero ranges flatten to a unit scale.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def sanitized_residual(raw: torch.Tensor, dec: torch.Tensor
                       ) -> torch.Tensor:
    """Per-element quantization residual ``raw - dec`` in f32 with
    non-finite entries zeroed, so a NaN/Inf delta cannot poison the
    error-feedback accumulator."""
    r = raw.float() - dec.float()
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


class DeltaCodec:
    """Base codec interface over the (K, N) client stack."""

    name: str = "abstract"
    lossy: bool = False

    def encode_cohort(self, stacked: torch.Tensor,
                      leaf_offsets: torch.Tensor):
        raise NotImplementedError

    def decode_cohort(self, payload, leaf_offsets: torch.Tensor
                      ) -> torch.Tensor:
        raise NotImplementedError

    def client_bytes(self, numels: Sequence[int]) -> int:
        """Uplink wire bytes ONE client pays per round for a delta with
        leaves of ``numels`` elements."""
        raise NotImplementedError

    def config_dict(self) -> Dict:
        return {"name": self.name}


_REGISTRY: Dict[str, Callable[[], DeltaCodec]] = {}

# registered in the reference, not ported yet: name -> why
NOT_PORTED = {
    "int8_sr": "int8_sr rounds stochastically with jax.random noise; its "
               "port needs a seam that feeds the noise in and a test of "
               "unbiasedness (ROADMAP Queue 1 item 9)",
}


def register_codec(name: str):
    """Decorator: ``@register_codec("mycodec")`` over a zero-arg factory
    (or codec class) adds it to the name registry."""
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"codec {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def make_codec(name: Optional[str]) -> Optional[DeltaCodec]:
    """Build a codec by registry name; None/"" -> None (codec off)."""
    if not name:
        return None
    if name in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[name])
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered: "
                         f"{', '.join(sorted(_REGISTRY))}") from None
    return factory()


def codec_names():
    return tuple(sorted(_REGISTRY))
