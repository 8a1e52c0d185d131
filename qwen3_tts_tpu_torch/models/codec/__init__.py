from .encoder import Encoder12Hz, MimiEncoderConfig
from .legacy_decoder import CodecDecoder, LegacyDecoderConfig
from .quantizer import ResidualVectorQuantizer, VectorQuantizer
from .vocoder import VocoderConfig, decode_bucketed, init_vocoder_params, load_vocoder_params

__all__ = [
    "CodecDecoder",
    "Encoder12Hz",
    "LegacyDecoderConfig",
    "MimiEncoderConfig",
    "ResidualVectorQuantizer",
    "VectorQuantizer",
    "VocoderConfig",
    "decode_bucketed",
    "init_vocoder_params",
    "load_vocoder_params",
]
