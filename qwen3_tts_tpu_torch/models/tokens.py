"""Token ID tables for Qwen3-TTS.

Special token IDs, language IDs, and preset speaker IDs used to build
prompt layouts. A framework-free copy of ``qwen3_tts_tpu/models/tokens.py``;
``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass

# ChatML special tokens (text vocabulary).
IM_START = 151644
IM_END = 151645
ASSISTANT = 77091
NEWLINE = 198

# TTS text-stream control tokens (text vocabulary).
TTS_PAD = 151671
TTS_BOS = 151672
TTS_EOS = 151673

# Codec control tokens (codec vocabulary, size 3072).
CODEC_PAD = 2148
CODEC_BOS = 2149
CODEC_EOS = 2150
CODEC_THINK = 2154
CODEC_NOTHINK = 2155
CODEC_THINK_BOS = 2156
CODEC_THINK_EOS = 2157
CODEC_VOCAB_SIZE = 3072

# Number of codebooks per frame: 1 semantic + 15 acoustic.
NUM_CODE_GROUPS = 16

# Audio framing: 12.5 Hz codec frames, 24 kHz output -> 1920 samples/frame.
SAMPLES_PER_FRAME = 1920
OUTPUT_SAMPLE_RATE = 24000

# Codec-vocabulary language conditioning tokens
# (reference: src/models/talker.rs:92-108).
LANGUAGES: dict[str, int] = {
    "chinese": 2055,
    "english": 2050,
    "japanese": 2058,
    "korean": 2064,
    "german": 2053,
    "french": 2061,
    "russian": 2069,
    "portuguese": 2071,
    "spanish": 2054,
    "italian": 2070,
}

_LANGUAGE_ALIASES = {
    "en": "english",
    "zh": "chinese",
    "ja": "japanese",
    "ko": "korean",
    "de": "german",
    "fr": "french",
    "ru": "russian",
    "pt": "portuguese",
    "es": "spanish",
    "it": "italian",
}


def language_token_id(name: str) -> int:
    """Resolve a language name or ISO code to its codec token ID."""
    key = name.strip().lower()
    key = _LANGUAGE_ALIASES.get(key, key)
    if key not in LANGUAGES:
        raise ValueError(
            f"Unknown language: {name!r}. Supported: {sorted(LANGUAGES)} "
            f"plus ISO codes {sorted(_LANGUAGE_ALIASES)}"
        )
    return LANGUAGES[key]


@dataclass(frozen=True)
class SpeakerInfo:
    token_id: int
    native_language: str


# Preset speakers for CustomVoice variants
# (reference: src/models/talker.rs:143-172).
SPEAKERS: dict[str, SpeakerInfo] = {
    "serena": SpeakerInfo(3066, "chinese"),
    "vivian": SpeakerInfo(3065, "chinese"),
    "uncle_fu": SpeakerInfo(3010, "chinese"),
    "ryan": SpeakerInfo(3061, "english"),
    "aiden": SpeakerInfo(2861, "english"),
    "ono_anna": SpeakerInfo(2873, "japanese"),
    "sohee": SpeakerInfo(2864, "korean"),
    "eric": SpeakerInfo(2875, "chinese"),
    "dylan": SpeakerInfo(2878, "chinese"),
}

_SPEAKER_ALIASES = {"unclefu": "uncle_fu", "onoanna": "ono_anna"}


def speaker_info(name: str) -> SpeakerInfo:
    """Resolve a preset speaker name to its token ID and native language."""
    key = name.strip().lower()
    key = _SPEAKER_ALIASES.get(key, key)
    if key not in SPEAKERS:
        raise ValueError(f"Unknown speaker: {name!r}. Supported: {sorted(SPEAKERS)}")
    return SPEAKERS[key]
