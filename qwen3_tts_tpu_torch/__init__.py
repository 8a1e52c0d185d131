"""qwen3_tts_tpu_torch — the PyTorch/CUDA port of qwen3_tts_tpu.

The CustomVoice main path (prompt -> talker prefill -> frame loop with the
code predictor -> vocoder), staged or streamed chunk by chunk, voice cloning
(the speaker and Mimi encoders, x-vector and ICL prompts), voice design
and batched synthesis (``synthesize_batch``, ``synthesize_streaming_batch``),
in PyTorch, with the JAX package's Pallas kernels on those paths rewritten
by hand in CUDA for Hopper (``csrc/``); HF checkpoints load with
``Qwen3TTS.from_pretrained`` (the package's own safetensors reader and Qwen2
tokenizer), ``python -m qwen3_tts_tpu_torch`` is the command line and
``python -m qwen3_tts_tpu_torch.server`` the HTTP server (micro-batching,
stream coalescing, time-slicing, voice registration), and
``Qwen3TTS.shard`` spreads a model over a (dp, tp) mesh of cards
(``parallel.sharding.make_mesh``).
This package imports neither JAX nor ``qwen3_tts_tpu``; the tests hold it
against the JAX package.
"""

import torch as _torch

# The vocoder is f32 at full precision (the JAX package decodes under
# "highest" matmul precision). cuDNN convolutions default to TF32 on Ampere
# and later, and matmuls may be switched to it; pin both off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .audio.io import AudioBuffer, load_wav, save_wav  # noqa: E402
from .models import tokens  # noqa: E402
from .models.config import (  # noqa: E402
    CodePredictorConfig,
    ModelConfig,
    ModelType,
    TalkerConfig,
    config_for_variant,
    parse_config_json,
)
from .pipeline import (  # noqa: E402
    Qwen3TTS,
    StreamingBatchSession,
    StreamingSession,
    SynthesisOptions,
    SynthesisTiming,
    VoiceClonePrompt,
)

__all__ = [
    "AudioBuffer",
    "CodePredictorConfig",
    "ModelConfig",
    "ModelType",
    "Qwen3TTS",
    "StreamingBatchSession",
    "StreamingSession",
    "SynthesisOptions",
    "SynthesisTiming",
    "TalkerConfig",
    "VoiceClonePrompt",
    "config_for_variant",
    "load_wav",
    "parse_config_json",
    "save_wav",
    "tokens",
]
