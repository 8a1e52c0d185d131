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
from .audio.resample import resample, resample_to_24k  # noqa: E402
from .models import tokens  # noqa: E402
from .models.config import (  # noqa: E402
    CodePredictorConfig,
    ModelConfig,
    ModelType,
    SpeakerEncoderConfig,
    TalkerConfig,
    config_for_variant,
    parse_config_json,
)
from .models.tokens import CODEC_EOS as CODEC_EOS_TOKEN_ID  # noqa: E402
from .models.tokens import SAMPLES_PER_FRAME  # noqa: E402
from .ops.sampling import SamplingConfig  # noqa: E402
from .pipeline import (  # noqa: E402
    Qwen3TTS,
    StreamingBatchSession,  # noqa: F401 (importable here; not in the JAX package's __all__)
    StreamingSession,
    SynthesisOptions,
    SynthesisTiming,
    VoiceClonePrompt,
)
from .tokenizer import TextTokenizer  # noqa: E402

__version__ = "0.1.0"

# The JAX package's public names, one for one.
__all__ = [
    "AudioBuffer",
    "CODEC_EOS_TOKEN_ID",
    "CodePredictorConfig",
    "ModelConfig",
    "ModelType",
    "Qwen3TTS",
    "SAMPLES_PER_FRAME",
    "SamplingConfig",
    "SpeakerEncoderConfig",
    "StreamingSession",
    "SynthesisOptions",
    "SynthesisTiming",
    "TalkerConfig",
    "TextTokenizer",
    "VoiceClonePrompt",
    "config_for_variant",
    "load_wav",
    "parse_config_json",
    "resample",
    "resample_to_24k",
    "save_wav",
    "tokens",
]
