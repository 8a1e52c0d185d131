"""The program under test, ``qwen3_tts_tpu_torch``, and the calls the window makes into it.

The only module of the benchmark that imports the program. It builds the
program's configuration from the configuration file's widths (not from the
program's own table of variants), hands ``Qwen3TTS`` the benchmark's raw
weight trees, and drives one request through a public entry point:
``synthesize_with_voice`` for an utterance, ``synthesize_streaming`` and
``next_chunk`` for a stream. For the check it keeps the codes a request
served: the program's session holds them (``state.frames``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

import qwen3_tts_tpu_torch as q
from qwen3_tts_tpu_torch.models import talker as talker_module
from qwen3_tts_tpu_torch.models.codec.vocoder import VocoderConfig

SAMPLES_PER_FRAME = 1920  # 24 kHz audio, 12.5 codec frames a second


def model_config(dims: dict) -> "q.ModelConfig":
    t, c = dims["talker"], dims["code_predictor"]
    mrope = dims.get("mrope_section")
    talker = q.TalkerConfig(
        text_vocab_size=t["text_vocab_size"], text_embed_dim=t["text_hidden_size"], hidden_size=t["hidden_size"],
        text_proj_intermediate=t["text_hidden_size"], intermediate_size=t["intermediate_size"],
        num_hidden_layers=t["num_hidden_layers"], num_attention_heads=t["num_attention_heads"],
        num_key_value_heads=t["num_key_value_heads"], head_dim=t["head_dim"], rms_norm_eps=t["rms_norm_eps"],
        rope_theta=float(t["rope_theta"]), max_position_embeddings=t["max_position_embeddings"],
        codec_vocab_size=t["vocab_size"], mrope_section=tuple(mrope) if mrope else None)
    cp = q.CodePredictorConfig(
        hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"], num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"], head_dim=c["head_dim"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), vocab_size=c["vocab_size"], num_code_groups=c["num_code_groups"],
        codec_embed_dim=t["hidden_size"] if t["hidden_size"] != c["hidden_size"] else None)
    return q.ModelConfig(model_type=q.ModelType.CUSTOM_VOICE, model_size=dims.get("model_size", "custom"),
                         talker=talker, code_predictor=cp)


def vocoder_config(dims: dict) -> VocoderConfig:
    v = {k: tuple(x) if isinstance(x, list) else x for k, x in dims["vocoder"].items()}
    return VocoderConfig(**v)


def build(dims: dict, trees: tuple, tokenizer, quantize_int8: bool = False) -> "q.Qwen3TTS":
    """``Qwen3TTS`` from the raw (talker, code predictor, vocoder) trees; it
    fuses and packs them itself (``quantize_int8``: its int8 path)."""
    talker, cp, voc = trees
    return q.Qwen3TTS(model_config(dims), talker, cp, voc, tokenizer, vocoder_config=vocoder_config(dims),
                      quantize_int8=quantize_int8)


def options(req, mix: dict) -> "q.SynthesisOptions":
    """The request's options: its frames forced (random weights rarely reach
    EOS, and real speech has a length); a greedy request samples nothing and
    has no repetition penalty."""
    extra = {}
    if mix["entry"] == "stream":
        extra = dict(streaming_lookahead=mix["streaming_lookahead"], chunk_frames=mix["chunk_frames"],
                     first_chunk_frames=mix["first_chunk_frames"])
    return q.SynthesisOptions(max_length=req.frames, min_new_tokens=req.frames, seed=req.seed,
                              temperature=0.0 if req.greedy else mix["temperature"],
                              repetition_penalty=1.0 if req.greedy else 1.05, **extra)


@dataclass
class Served:
    """What one request gave back, on the host's clock."""

    frames: int
    samples: int = 0
    wall_s: float = 0.0
    first_s: float | None = None  # the call until the first chunk's samples were on the host
    chunks: list = field(default_factory=list)  # frames in each chunk handed back
    codes: torch.Tensor | None = None  # the session's frames buffer (greedy requests; rows 0..frames-1)
    audio: list | None = None  # the samples handed back (greedy requests)
    error: str | None = None


class Driver:
    """Drives requests through the model. For an utterance the model's
    ``_custom_voice_session`` is wrapped on this instance only, to keep the
    session that ``synthesize_with_voice`` runs and read its codes."""

    def __init__(self, model, mix: dict):
        self.model, self.mix = model, mix
        self.last_session = None
        if mix["entry"] == "utterance":
            inner = model._custom_voice_session

            def keep(*args, **kwargs):
                self.last_session = inner(*args, **kwargs)
                return self.last_session

            model._custom_voice_session = keep

    def run(self, req) -> Served:
        out = Served(req.frames)
        opts = options(req, self.mix)
        t0 = time.perf_counter()
        if self.mix["entry"] == "utterance":
            audio = self.model.synthesize_with_voice(req.text, req.speaker, req.language, opts).samples
            out.wall_s = time.perf_counter() - t0
            session, self.last_session = self.last_session, None
            parts = [audio]
            out.chunks = [len(audio) // SAMPLES_PER_FRAME]
        else:
            session = self.model.synthesize_streaming(req.text, req.speaker, req.language, opts)
            parts = []
            while (chunk := session.next_chunk()) is not None:
                if out.first_s is None:
                    out.first_s = time.perf_counter() - t0
                parts.append(chunk.samples)
                out.chunks.append(len(chunk.samples) // SAMPLES_PER_FRAME)
            out.wall_s = time.perf_counter() - t0
        out.samples = sum(len(p) for p in parts)
        if req.greedy:
            out.codes = session.state.frames
            out.audio = parts
        return out


class PrefillClock:
    """Wraps the program's ``models.talker.prefill`` (the talker's prefill,
    which every prompt layout runs) with the host clock, synchronising the
    device at its end, for the traced run's ``prefill_ms_p50``. Restores it
    on exit; records nothing if the program has no such function."""

    def __init__(self):
        self.seconds: list[float] = []
        self._orig = None

    def __enter__(self):
        orig = getattr(talker_module, "prefill", None)
        if orig is None:
            return self

        def timed(*args, **kwargs):
            with torch.profiler.record_function("bench.prefill"):
                t0 = time.perf_counter()
                result = orig(*args, **kwargs)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
            return result

        self._orig = orig
        talker_module.prefill = timed
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            talker_module.prefill = self._orig
        return False

