"""Model download helpers: a copy of ``qwen3_tts_tpu/hub.py`` (it imports no
framework).

Downloads a variant checkpoint plus the shared speech tokenizer and text
tokenizer from HuggingFace Hub into one local directory laid out the way
``Qwen3TTS.from_pretrained`` expects. Requires network access; in air-gapped
environments point ``from_pretrained`` at an existing local directory
instead.
"""

from __future__ import annotations

from pathlib import Path

MODEL_IDS = {
    "0.6b-base": "Qwen/Qwen3-TTS-12Hz-0.6B-Base",
    "0.6b-customvoice": "Qwen/Qwen3-TTS-12Hz-0.6B-CustomVoice",
    "1.7b-base": "Qwen/Qwen3-TTS-12Hz-1.7B-Base",
    "1.7b-customvoice": "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
    "1.7b-voicedesign": "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign",
}
SPEECH_TOKENIZER_ID = "Qwen/Qwen3-TTS-Tokenizer-12Hz"
TEXT_TOKENIZER_ID = "Qwen/Qwen2-0.5B"


def download(variant: str = "0.6b-base", dest: str | Path = "models", revision: str | None = None) -> Path:
    """Fetch model.safetensors + config.json, the speech tokenizer, and the
    text tokenizer. Returns the model directory for ``Qwen3TTS.from_pretrained``."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "huggingface_hub is required for downloads; in offline environments "
            "provide a local checkpoint directory instead"
        ) from e

    repo = MODEL_IDS.get(variant.lower(), variant)
    dest = Path(dest) / repo.split("/")[-1]
    dest.mkdir(parents=True, exist_ok=True)

    for fname in ("model.safetensors", "config.json"):
        hf_hub_download(repo, fname, revision=revision, local_dir=dest)

    st_dir = dest / "speech_tokenizer"
    st_dir.mkdir(exist_ok=True)
    for fname in ("model.safetensors", "config.json", "preprocessor_config.json"):
        try:
            hf_hub_download(SPEECH_TOKENIZER_ID, fname, local_dir=st_dir)
        except Exception:  # noqa: BLE001 — config files optional
            if fname == "model.safetensors":
                raise

    try:
        hf_hub_download(TEXT_TOKENIZER_ID, "tokenizer.json", local_dir=dest)
    except Exception:  # noqa: BLE001 — fall back to vocab+merges pipeline
        for fname in ("vocab.json", "merges.txt", "tokenizer_config.json"):
            hf_hub_download(TEXT_TOKENIZER_ID, fname, local_dir=dest)

    return dest
