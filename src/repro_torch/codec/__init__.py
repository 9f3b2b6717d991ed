"""repro_torch.codec — communication-compressed client deltas on the flat
layout (counterpart of repro/codec).

A ``DeltaCodec`` sits between local training and aggregation: clients
quantize their update rows (the uplink payload), the server decodes —
or hands the payload to the FedDPC dequant folds — and an optional
server-side error-feedback accumulator re-injects the quantization error.

Codecs register by name (``identity`` / ``bf16`` / ``int8`` /
``int8_sym`` / ``int8_sr``); ``make_codec(name)`` builds one,
``codec_names()`` and ``CODEC_NAMES`` enumerate the registry.
"""
from repro_torch.codec.base import (DeltaCodec, EncodedCohort, codec_names,
                                    make_codec, register_codec,
                                    sanitized_residual, tree_nbytes)
from repro_torch.codec.codecs import BF16Codec, IdentityCodec, Int8Codec

# the registry's names once the built-in codecs above have registered: a
# stable tuple for argparse choices
CODEC_NAMES = codec_names()

__all__ = ["BF16Codec", "CODEC_NAMES", "DeltaCodec", "EncodedCohort",
           "IdentityCodec", "Int8Codec", "codec_names", "make_codec",
           "register_codec", "sanitized_residual", "tree_nbytes"]
