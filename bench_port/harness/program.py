"""The program under test, ``qwen3_tts_tpu_torch``, and the calls the window makes into it.

The only module of the benchmark that imports the program. It builds the
program's configuration from the configuration file's widths and model type
(not from the program's own table of variants), hands ``Qwen3TTS`` the
benchmark's raw weight trees (and a Base model's two audio encoders, built
from the benchmark's trees by the program's public constructors), and
drives one request through the public entry point of its prompt layout:
``synthesize_with_voice`` / ``synthesize_streaming`` for a preset speaker,
``synthesize_voice_clone`` / ``_streaming`` for a clone (its prompt made by
``create_voice_clone_prompt``), ``synthesize_voice_design`` / ``_streaming``
for a description; a stream is pulled with ``next_chunk``. For the check it
keeps the codes a request served (the program's session holds them:
``state.frames``) and a clone's prompt: the x-vector and the reference
codes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

import qwen3_tts_tpu_torch as q
from qwen3_tts_tpu_torch.models import talker as talker_module
from qwen3_tts_tpu_torch.models.codec.encoder import Encoder12Hz, MimiEncoderConfig
from qwen3_tts_tpu_torch.models.codec.vocoder import VocoderConfig
from qwen3_tts_tpu_torch.models.speaker import SpeakerEncoder

from . import roofline, spec, traffic

SAMPLES_PER_FRAME = 1920  # 24 kHz audio, 12.5 codec frames a second
# The session a layout's entry points open, wrapped to keep it.
SESSIONS = {"preset": "_custom_voice_session", "xvector": "_voice_clone_session", "icl": "_voice_clone_session",
            "design": "_voice_design_session"}


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
    se = dims.get("speaker_encoder")
    speaker = None
    if se:
        speaker = q.SpeakerEncoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in se.items()})
    return q.ModelConfig(model_type=q.ModelType(dims.get("model_type", "custom_voice")),
                         model_size=dims.get("model_size", "custom"), talker=talker, code_predictor=cp,
                         speaker_encoder=speaker)


def vocoder_config(dims: dict) -> VocoderConfig:
    v = {k: tuple(x) if isinstance(x, list) else x for k, x in dims["vocoder"].items()}
    return VocoderConfig(**v)


def speech_encoder_config(dims: dict) -> MimiEncoderConfig:
    """The program's speech-encoder configuration from the file's
    ``encoder_config`` (the speech tokenizer's names)."""
    e = dims["speech_encoder"]
    return MimiEncoderConfig(
        sampling_rate=e["sampling_rate"], num_filters=e["num_filters"], ratios=tuple(e["upsampling_ratios"]),
        kernel_size=e["kernel_size"], last_kernel_size=e["last_kernel_size"],
        residual_kernel_size=e["residual_kernel_size"], compress=e["compress"], hidden_size=e["hidden_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"], head_dim=e["head_dim"],
        intermediate_size=e["intermediate_size"], norm_eps=e["norm_eps"], rope_theta=float(e["rope_theta"]),
        sliding_window=e["sliding_window"], layer_scale=e["layer_scale_initial_scale"],
        codebook_size=e["codebook_size"], codebook_dim=e["codebook_dim"], num_quantizers=e["num_quantizers"],
        downsample_stride=spec.downsample_stride(e))


def build(dims: dict, trees: tuple, tokenizer, quantize_int8: bool = False,
          encoders: dict | None = None) -> "q.Qwen3TTS":
    """``Qwen3TTS`` from the raw (talker, code predictor, vocoder) trees; it
    fuses and packs them itself (``quantize_int8``: its int8 path).
    ``encoders`` (``weights.draw_encoders``): a Base model's speaker and
    speech encoders, built by ``SpeakerEncoder.from_weights`` and
    ``Encoder12Hz.from_weights`` on the device that holds them."""
    talker, cp, voc = trees
    encoders = encoders or {}
    config = model_config(dims)
    speaker = speech = None
    if "speaker_encoder" in encoders:
        speaker = SpeakerEncoder.from_weights(encoders["speaker_encoder"], config.speaker_encoder)
    if "speech_encoder" in encoders:
        speech = Encoder12Hz.from_weights(encoders["speech_encoder"], speech_encoder_config(dims))
    return q.Qwen3TTS(config, talker, cp, voc, tokenizer, speaker, speech, vocoder_config=vocoder_config(dims),
                      quantize_int8=quantize_int8)


def options(req, mix: dict) -> "q.SynthesisOptions":
    """The request's options: its frames forced (random weights rarely reach
    EOS, and real speech has a length); a greedy request samples nothing and
    asks for no repetition penalty."""
    extra = {}
    if mix["entry"] == "stream":
        extra = dict(streaming_lookahead=mix["streaming_lookahead"], chunk_frames=mix["chunk_frames"],
                     first_chunk_frames=mix["first_chunk_frames"])
    if mix.get("icl_sequential"):
        extra["icl_sequential"] = True
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
    xvector: np.ndarray | None = None  # a clone's x-vector as served (greedy requests)
    ref_codes: np.ndarray | None = None  # an in-context clone's reference codes as served (greedy requests)
    layout: dict = field(default_factory=dict)  # the prompt's counts for ``roofline.request_flops``
    error: str | None = None


class Driver:
    """Drives requests through the model. For an utterance the model's
    session of the mix's layout (``SESSIONS``) is wrapped on this instance
    only, to keep the session that the entry point runs and read its codes.
    A clone's voices are the mix's (``traffic.voices``), and ``dims`` its
    configuration's (``spec.dims``), for the encoders' counts; with
    ``clone_prompt`` ``per_voice`` their prompts are made once, by
    ``prepare``, in set-up."""

    def __init__(self, model, mix: dict, voices: list | None = None, dims: dict | None = None):
        self.model, self.mix, self.dims = model, mix, dims
        self.prompt = mix.get("prompt", "preset")
        self.voices = voices or []
        self.kept: dict = {}  # per_voice: a voice's prompt
        self.last_session = None
        if mix["entry"] == "utterance":
            name = SESSIONS[self.prompt]
            inner = getattr(model, name)

            def keep(*args, **kwargs):
                self.last_session = inner(*args, **kwargs)
                return self.last_session

            setattr(model, name, keep)

    def _clone_prompt(self, voice):
        ref_text = voice.ref_text if self.prompt == "icl" else None
        return self.model.create_voice_clone_prompt(q.AudioBuffer(voice.samples, traffic.SAMPLE_RATE), ref_text)

    def prepare(self) -> None:
        """Set-up of a clone mix: each voice's prompt made once, which runs
        the encoders on every clip the window will send; ``per_voice`` keeps
        them for the window."""
        for voice in self.voices:
            prompt = self._clone_prompt(voice)
            if self.mix.get("clone_prompt") == "per_voice":
                self.kept[voice.index] = prompt

    def _open(self, req, opts):
        """The layout's call: (audio, session, prompt), the utterance's samples
        or the stream's session (the other None), and the clone prompt it
        served (None for another layout)."""
        m, stream = self.model, self.mix["entry"] == "stream"
        if self.prompt == "preset":
            if stream:
                return None, m.synthesize_streaming(req.text, req.speaker, req.language, opts), None
            return m.synthesize_with_voice(req.text, req.speaker, req.language, opts).samples, None, None
        if self.prompt == "design":
            if stream:
                return None, m.synthesize_voice_design_streaming(req.text, req.instruct, req.language, opts), None
            return m.synthesize_voice_design(req.text, req.instruct, req.language, opts).samples, None, None
        prompt = self.kept[req.voice] if req.voice in self.kept else self._clone_prompt(self.voices[req.voice])
        if stream:
            return None, m.synthesize_voice_clone_streaming(req.text, prompt, req.language, opts), prompt
        return m.synthesize_voice_clone(req.text, prompt, req.language, opts).samples, None, prompt

    def _layout(self, req, prompt) -> dict:
        """The prompt's counts that ``roofline.request_flops`` takes beyond a
        preset speaker's: {} for one."""
        if self.prompt == "preset":
            return {}
        text = len(req.text_ids)
        if self.prompt == "design":
            rows = len(traffic.instruct_ids(req.instruct)) + 9
            return {"prompt_rows": rows, "text_rows": rows + text + 1}
        out = {}
        if self.mix.get("clone_prompt") != "per_voice":
            out["encoder_flops"] = roofline.encoder_flops(self.dims, len(self.voices[req.voice].samples),
                                                          self.prompt == "icl")
        if self.prompt == "xvector":
            return out
        prefix = len(prompt.ref_codes)
        n_text = len(prompt.ref_text_ids) + text + 1
        rows = 9 + prefix + 1 + (n_text if self.mix.get("icl_sequential") else 0)
        return dict(out, prompt_rows=rows, text_rows=9 + n_text + 1, prefix_frames=prefix)

    def run(self, req) -> Served:
        out = Served(req.frames)
        opts = options(req, self.mix)
        t0 = time.perf_counter()
        audio, session, prompt = self._open(req, opts)
        if session is None:
            out.wall_s = time.perf_counter() - t0
            session, self.last_session = self.last_session, None
            parts = [audio]
            out.chunks = [len(audio) // SAMPLES_PER_FRAME]
        else:
            parts = []
            while (chunk := session.next_chunk()) is not None:
                if out.first_s is None:
                    out.first_s = time.perf_counter() - t0
                parts.append(chunk.samples)
                out.chunks.append(len(chunk.samples) // SAMPLES_PER_FRAME)
            out.wall_s = time.perf_counter() - t0
        out.samples = sum(len(p) for p in parts)
        out.layout = self._layout(req, prompt)
        if req.greedy:
            out.codes = session.state.frames
            out.audio = parts
            if prompt is not None:
                out.xvector = np.asarray(prompt.speaker_embedding, np.float32)
                out.ref_codes = None if prompt.ref_codes is None else np.asarray(prompt.ref_codes)
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
