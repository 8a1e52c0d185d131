"""Model configuration: variants, dimensions, HF config.json parsing.

Covers the five official Qwen3-TTS variants (0.6B/1.7B x Base/CustomVoice,
1.7B VoiceDesign). A framework-free copy of
``qwen3_tts_tpu/models/config.py`` (held equal by
``tests/test_torch_copies.py``); ``LayerStackConfig`` comes from this
package's own ``ops/nn.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

from ..ops.nn import LayerStackConfig


class ModelType(str, Enum):
    BASE = "base"
    CUSTOM_VOICE = "custom_voice"
    VOICE_DESIGN = "voice_design"


@dataclass(frozen=True)
class TalkerConfig:
    text_vocab_size: int = 151936
    text_embed_dim: int = 2048
    hidden_size: int = 1024
    text_proj_intermediate: int = 2048
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_position_embeddings: int = 32768
    codec_vocab_size: int = 3072
    # MRoPE section [24, 20, 20]: for TTS all three position streams are
    # equal, so it reduces to standard RoPE; [3, S] position streams take
    # interleaved MRoPE (``nn.run_layer_stack(..., positions_thw=)``).
    mrope_section: tuple[int, int, int] | None = (24, 20, 20)
    # Tiered decode attention on the batch-1 layer path (see
    # LayerStackConfig.decode_tiering; off by default, as in the JAX package).
    decode_tiering: bool = False

    def layer_stack(self) -> LayerStackConfig:
        return LayerStackConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.num_attention_heads,
            num_kv_heads=self.num_key_value_heads,
            head_dim=self.head_dim,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
            mrope_section=tuple(self.mrope_section) if self.mrope_section else None,
            decode_tiering=self.decode_tiering,
        )


def talker_config_1p7b() -> TalkerConfig:
    return TalkerConfig(hidden_size=2048, intermediate_size=6144)


@dataclass(frozen=True)
class CodePredictorConfig:
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    vocab_size: int = 2048
    num_code_groups: int = 16
    # Equals the talker hidden size; when it differs from hidden_size the
    # small_to_mtp_projection bridges codec embeddings into the CP stack
    # (1.7B models: 2048 -> 1024).
    codec_embed_dim: int | None = None
    # "sequential": 15 cached single-token steps (default). "jacobi":
    # batched fixed-point greedy decode — exact, one weight pass per
    # iteration; faster only when codes converge in few iterations (real
    # trained weights condition strongly on the talker hidden state), slower
    # on unstructured/random weights. Benchmark per checkpoint.
    decode_mode: str = "sequential"

    @property
    def embed_dim(self) -> int:
        return self.codec_embed_dim or self.hidden_size

    @property
    def num_acoustic(self) -> int:
        return self.num_code_groups - 1

    @property
    def needs_projection(self) -> bool:
        return self.embed_dim != self.hidden_size

    def layer_stack(self) -> LayerStackConfig:
        return LayerStackConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.num_attention_heads,
            num_kv_heads=self.num_key_value_heads,
            head_dim=self.head_dim,
            rms_norm_eps=self.rms_norm_eps,
            rope_theta=self.rope_theta,
        )


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: tuple[int, ...] = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000


@dataclass(frozen=True)
class ModelConfig:
    """Top-level parsed model configuration for one variant."""

    model_type: ModelType = ModelType.BASE
    model_size: str = "0b6"
    talker: TalkerConfig = field(default_factory=TalkerConfig)
    code_predictor: CodePredictorConfig = field(default_factory=CodePredictorConfig)
    speaker_encoder: SpeakerEncoderConfig | None = None

    @property
    def label(self) -> str:
        size = {"0b6": "0.6B", "1b7": "1.7B"}.get(self.model_size, self.model_size)
        variant = {
            ModelType.BASE: "Base",
            ModelType.CUSTOM_VOICE: "CustomVoice",
            ModelType.VOICE_DESIGN: "VoiceDesign",
        }[self.model_type]
        return f"{size} {variant}"

    @property
    def supports_preset_speakers(self) -> bool:
        return self.model_type == ModelType.CUSTOM_VOICE

    @property
    def supports_voice_cloning(self) -> bool:
        return self.speaker_encoder is not None

    @property
    def supports_voice_design(self) -> bool:
        return self.model_type == ModelType.VOICE_DESIGN


def _get(d: dict, key: str, default):
    v = d.get(key)
    return default if v is None else v


def parse_config_json(path: str | Path) -> ModelConfig:
    """Parse a HuggingFace config.json into a ModelConfig.

    Same field resolution and defaults as the JAX package's parser.
    """
    v = json.loads(Path(path).read_text())

    model_type = {
        "custom_voice": ModelType.CUSTOM_VOICE,
        "voice_design": ModelType.VOICE_DESIGN,
    }.get(v.get("tts_model_type", "base"), ModelType.BASE)
    model_size = v.get("tts_model_size", "unknown")

    t = v.get("talker_config", {}) or {}
    cp = t.get("code_predictor_config", {}) or {}

    mrope = None
    rope_scaling = t.get("rope_scaling") or {}
    section = rope_scaling.get("mrope_section")
    if isinstance(section, list) and len(section) == 3:
        mrope = tuple(int(x) for x in section)

    talker = TalkerConfig(
        text_vocab_size=int(_get(t, "text_vocab_size", 151936)),
        text_embed_dim=int(_get(t, "text_hidden_size", 2048)),
        hidden_size=int(_get(t, "hidden_size", 1024)),
        text_proj_intermediate=int(_get(t, "text_hidden_size", 2048)),
        intermediate_size=int(_get(t, "intermediate_size", 3072)),
        num_hidden_layers=int(_get(t, "num_hidden_layers", 28)),
        num_attention_heads=int(_get(t, "num_attention_heads", 16)),
        num_key_value_heads=int(_get(t, "num_key_value_heads", 8)),
        head_dim=int(_get(t, "head_dim", 128)),
        rms_norm_eps=float(_get(t, "rms_norm_eps", 1e-6)),
        rope_theta=float(_get(t, "rope_theta", 1e6)),
        max_position_embeddings=int(_get(t, "max_position_embeddings", 32768)),
        codec_vocab_size=int(_get(t, "vocab_size", 3072)),
        mrope_section=mrope,
    )

    cp_hidden = int(_get(cp, "hidden_size", 1024))
    code_predictor = CodePredictorConfig(
        hidden_size=cp_hidden,
        intermediate_size=int(_get(cp, "intermediate_size", 3072)),
        num_hidden_layers=int(_get(cp, "num_hidden_layers", 5)),
        num_attention_heads=int(_get(cp, "num_attention_heads", 16)),
        num_key_value_heads=int(_get(cp, "num_key_value_heads", 8)),
        head_dim=int(_get(cp, "head_dim", 128)),
        rms_norm_eps=float(_get(cp, "rms_norm_eps", 1e-6)),
        rope_theta=float(_get(cp, "rope_theta", 1e6)),
        vocab_size=int(_get(cp, "vocab_size", 2048)),
        num_code_groups=int(_get(cp, "num_code_groups", 16)),
        codec_embed_dim=talker.hidden_size if talker.hidden_size != cp_hidden else None,
    )

    speaker_encoder = None
    se = v.get("speaker_encoder_config")
    if isinstance(se, dict):
        speaker_encoder = SpeakerEncoderConfig(
            enc_dim=int(_get(se, "enc_dim", 1024)),
            sample_rate=int(_get(se, "sample_rate", 24000)),
        )

    return ModelConfig(
        model_type=model_type,
        model_size=model_size,
        talker=talker,
        code_predictor=code_predictor,
        speaker_encoder=speaker_encoder,
    )


def config_for_variant(size: str = "0.6B", variant: str = "base") -> ModelConfig:
    """Construct a known-variant config without a config.json (e.g. for
    synthetic-weight benchmarking)."""
    size_key = {"0.6b": "0b6", "1.7b": "1b7"}[size.lower()]
    talker = TalkerConfig() if size_key == "0b6" else talker_config_1p7b()
    cp = CodePredictorConfig(
        codec_embed_dim=talker.hidden_size if talker.hidden_size != 1024 else None
    )
    mt = {
        "base": ModelType.BASE,
        "custom_voice": ModelType.CUSTOM_VOICE,
        "customvoice": ModelType.CUSTOM_VOICE,
        "voice_design": ModelType.VOICE_DESIGN,
        "voicedesign": ModelType.VOICE_DESIGN,
    }[variant.lower()]
    se = SpeakerEncoderConfig(enc_dim=talker.hidden_size) if mt == ModelType.BASE else None
    return ModelConfig(
        model_type=mt,
        model_size=size_key,
        talker=talker,
        code_predictor=cp,
        speaker_encoder=se,
    )
