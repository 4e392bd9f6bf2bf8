"""Wire compression for the flat-row gossip payload (see
:mod:`repro_torch.wire.codec` for the format contract)."""

from .codec import (WIRE_CODECS, Bf16Codec, Int4BlockCodec, Int8BlockCodec,
                    NoneCodec, TopKCodec, WireCodec, get_codec)

__all__ = ["WIRE_CODECS", "WireCodec", "NoneCodec", "Bf16Codec",
           "Int8BlockCodec", "Int4BlockCodec", "TopKCodec", "get_codec"]
