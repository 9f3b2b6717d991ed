"""repro_torch.codec — communication-compressed client deltas on the flat
layout (counterpart of repro/codec).

A ``DeltaCodec`` sits between local training and aggregation: clients
quantize their update rows (the uplink payload), the server decodes —
or hands the payload to the FedDPC dequant folds — and an optional
server-side error-feedback accumulator re-injects the quantization error.

Codecs register by name (``identity`` / ``bf16`` / ``int8`` /
``int8_sym``); ``make_codec(name)`` builds one, ``codec_names()``
enumerates the registry.
"""
from repro_torch.codec.base import (DeltaCodec, codec_names, make_codec,
                                    register_codec, sanitized_residual)
from repro_torch.codec.codecs import BF16Codec, IdentityCodec, Int8Codec

__all__ = ["BF16Codec", "DeltaCodec", "IdentityCodec", "Int8Codec",
           "codec_names", "make_codec", "register_codec",
           "sanitized_residual"]
