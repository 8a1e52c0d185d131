"""Qwen3TTS facade: prompt -> prefill -> frame loop -> vocoder decode.

PyTorch port of the CustomVoice batch-1 path of ``qwen3_tts_tpu/pipeline.py``
(``synthesize``, ``synthesize_with_voice``, ``synthesize_with_timing``,
``synthesize_streaming``, ``decode_codes``, ``SynthesisOptions``,
``SynthesisTiming``, ``StreamingSession``). Every synthesis runs through a
``StreamingSession``: its buffers start at ``GROWTH_INITIAL_FRAMES`` frames
and grow one ``FRAME_BUCKETS`` tier at a time between re-entries of the
frame loop. ``synthesize_with_voice`` decodes chunk by chunk on the
sample-exact streaming vocoder (``run_to_audio``),
``synthesize_with_timing`` runs the loop to its end, then one bucketed
decode, and ``synthesize_streaming`` hands the session to the caller
(``next_chunk`` / iteration). Weight-only int8 (``quantize_int8=True``) is
ported. Voice cloning (and with it the ICL reference prefix of a stream),
voice design and batching are not ported yet.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from .audio.io import AudioBuffer
from .generation import core, prefill
from .models import code_predictor as cp
from .models import tokens as T
from .models import weights as W
from .models.codec import vocoder
from .models.config import ModelConfig, ModelType
from .ops import fused_layer, nn, quant, rng, sampling
from .utils.bucketing import next_bucket

logger = logging.getLogger("qwen3_tts_tpu_torch")

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
TEXT_BUCKET = 32
DECODE_BUCKET = 64
CUSTOM_VOICE_PROMPT_LEN = 10
# Sessions start with this frame capacity and grow through FRAME_BUCKETS
# between re-entries of the frame loop, so decode attention reads the live
# tier's cache rows rather than the largest bucket's.
GROWTH_INITIAL_FRAMES = 256


def _device_or_card(device: torch.device | str | None) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when there is no
    card rather than building the model on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("Qwen3TTS: no CUDA device; pass device='cpu' to build the model on the CPU")
    return torch.device("cuda")


@dataclass(frozen=True)
class SynthesisOptions:
    """Generation options; the defaults match the JAX package's (its ICL
    layout option waits for voice cloning)."""

    max_length: int = 2048
    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.05
    eos_token_id: int = T.CODEC_EOS
    chunk_frames: int = 10
    # Streaming: the first chunk holds this many frames (then chunk_frames),
    # so the first audio waits for 4 frames, not 10. None = chunk_frames.
    first_chunk_frames: int | None = 4
    min_new_tokens: int = 2
    seed: int | None = None
    # Sample-exact streaming: the vocoder carries its causal state across
    # chunks, so the streamed audio is the batch decode's. False = each
    # chunk decoded with chunk-local context only.
    streaming_exact: bool = True
    # Chunks to run ahead of the one being returned. Accepted for the JAX
    # package's interface; the port runs each chunk when it is asked for
    # (its frame loop reads ``done`` on the host every frame, so work queued
    # ahead would run before the chunk returns), and every value gives the
    # same chunks.
    streaming_lookahead: int = 1

    def sampling_config(self) -> sampling.SamplingConfig:
        return sampling.SamplingConfig(
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            repetition_penalty=self.repetition_penalty,
            eos_token_id=self.eos_token_id,
            min_new_tokens=self.min_new_tokens,
        )


@dataclass
class SynthesisTiming:
    prefill_ms: float = 0.0
    generation_ms: float = 0.0
    generation_frames: int = 0
    decode_ms: float = 0.0


class Qwen3TTS:
    """End-to-end CustomVoice TTS on one device (a CUDA card, or the CPU).

    The code predictor's layer weights are kept fused (q|k|v, gate|up): the
    frame kernel takes that layout. On a CUDA card the talker is fused too,
    once, here: its decode steps then run the whole-step talker kernel on
    plain weights (the JAX package's plain stream pack, without its [H, H]
    tile re-layout), and the separate projections are dropped. On the CPU
    the talker keeps the separate projections, as the JAX package's main
    path does (a talker tree handed in fused stays fused). Prefill runs the
    layer path on either tree.

    ``quantize_int8=True``: weight-only int8, as the JAX package's (without
    its [H, H] stream-tile re-layout). The talker and the code predictor are
    fused (unless already), then their layer projections, the codec head and
    the lm heads are quantized; decode steps then run the whole-step talker
    kernel and the int8 code-predictor frame (or, for a code predictor the
    frame kernel does not take, its per-step kernels:
    ``models/code_predictor``), the prefill and codec head the W8A16 matmul.

    On the card, a code predictor that takes the frame kernel gets its
    ``fused_layer.CpFramePack`` here (one that takes kernel 7 per step its
    ``fused_layer.CpStepPack``), and the fused talker its
    ``fused_layer.TalkerStepPack`` (each checked, packed and given its
    scratch once); every frame of this model uses them, on the stream of
    the first.

    ``from_random`` and ``from_numpy`` build on the CUDA card unless given
    ``device="cpu"``.
    """

    def __init__(
        self,
        config: ModelConfig,
        talker_params: dict,
        cp_params: dict,
        vocoder_params: dict,
        tokenizer=None,
        vocoder_config: vocoder.VocoderConfig = vocoder.VocoderConfig(),
        quantize_int8: bool = False,
    ):
        self.config = config
        if "qkv_proj" not in cp_params["layers"]:
            cp_params = W.fuse_model_params(cp_params)
        on_card = talker_params["norm"].device.type == "cuda"
        if (quantize_int8 or on_card) and "qkv_proj" not in talker_params["layers"]:
            talker_params = W.fuse_model_params(talker_params)
        if quantize_int8:
            talker_params = quant.quantize_talker_params(talker_params)
            cp_params = quant.quantize_code_predictor_params(cp_params)
        self.talker_params = talker_params
        self.cp_params = cp_params
        self.compute_dtype = talker_params["norm"].dtype
        self.device = talker_params["norm"].device
        self.cp_frame_pack = self.cp_step_pack = None
        route = cp.cp_route(cp_params, config.code_predictor) if on_card else None
        if route == "frame":
            self.cp_frame_pack = fused_layer.CpFramePack(cp_params, config.code_predictor, self.compute_dtype,
                                                         self.device)
        elif route == "streamed_step":
            self.cp_step_pack = fused_layer.CpStepPack(cp_params["layers"], config.code_predictor.layer_stack(),
                                                       self.compute_dtype, self.device)
        self.talker_step_pack = None
        layers, stack = talker_params["layers"], config.talker.layer_stack()
        if (on_card and fused_layer.has_stream_pack(layers, stack.hidden_size)
                and fused_layer.supports_talker_step_kernel(layers, stack, fused_layer.TALKER_STREAM_MAX_SEQ)):
            self.talker_step_pack = fused_layer.TalkerStepPack(layers, stack, self.compute_dtype, self.device)
        self.vocoder_params = vocoder_params
        self.vocoder_config = vocoder_config
        self.tokenizer = tokenizer

    @classmethod
    def from_random(
        cls,
        config: ModelConfig,
        seed: int = 0,
        device: torch.device | str | None = None,
        tokenizer=None,
        quantize_int8: bool = False,
    ) -> "Qwen3TTS":
        """Synthetic weights at real dimensions, drawn from ``seed`` on
        ``device`` (bf16 talker and code predictor, f32 vocoder). The
        default device is the CUDA card; ``device="cpu"`` builds on the CPU."""
        device = _device_or_card(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(
            config,
            W.init_talker_params(gen, config.talker),
            W.init_code_predictor_params(gen, config.code_predictor),
            vocoder.init_vocoder_params(gen),
            tokenizer,
            quantize_int8=quantize_int8,
        )

    @classmethod
    def from_numpy(
        cls,
        config: ModelConfig,
        talker_tree: dict,
        cp_tree: dict,
        vocoder_tree: dict,
        tokenizer=None,
        vocoder_config: vocoder.VocoderConfig = vocoder.VocoderConfig(),
        device: torch.device | str | None = None,
        quantize_int8: bool = False,
    ) -> "Qwen3TTS":
        """A model from a JAX model's parameter trees converted to numpy
        (``jax.tree.map(np.asarray, model.talker_params)`` etc.), on
        ``device``: the CUDA card by default, or ``device="cpu"``."""
        device = _device_or_card(device)
        return cls(
            config,
            W.from_numpy_tree(talker_tree, device),
            W.from_numpy_tree(cp_tree, device),
            W.from_numpy_tree(vocoder_tree, device),
            tokenizer,
            vocoder_config=vocoder_config,
            quantize_int8=quantize_int8,
        )

    # ------------------------------------------------------------------
    # Internal helpers
    # ------------------------------------------------------------------

    def _encode_text(self, text: str) -> list[int]:
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer loaded")
        ids = self.tokenizer.encode(text)
        if not ids:
            raise ValueError("Cannot synthesize empty text (no tokens)")
        return ids

    def _pad_ids(self, ids: list[int]) -> tuple[torch.Tensor, int]:
        arr = np.zeros(next_bucket(max(len(ids), 1), TEXT_BUCKET), np.int64)
        arr[: len(ids)] = ids
        return torch.from_numpy(arr).to(self.device), len(ids)

    def _uniforms(self, seed: int | None, n: int) -> torch.Tensor:
        seq = (
            rng.pcg_uniform_sequence(seed, n + 1)
            if seed is not None
            else rng.unseeded_uniform_sequence(n + 1)
        )
        return torch.from_numpy(seq).to(self.device)

    def _new_cache(self, prompt_len: int, max_new: int) -> nn.KVCache:
        rows = ((prompt_len + max_new + 8 + 15) // 16) * 16
        return nn.init_kv_cache(
            self.config.talker.layer_stack(), 1, rows, self.compute_dtype, self.device
        )

    def _normalize_options(self, options: SynthesisOptions) -> SynthesisOptions:
        """Clamp max_length to the largest frame bucket (2048 frames)."""
        if options.max_length > FRAME_BUCKETS[-1]:
            logger.warning(
                "max_length=%d exceeds the %d-frame ceiling; clamping.",
                options.max_length,
                FRAME_BUCKETS[-1],
            )
            options = replace(options, max_length=FRAME_BUCKETS[-1])
        if options.max_length < 1:
            raise ValueError(f"max_length must be >= 1, got {options.max_length}")
        return options

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warn_preset_speaker(self, speaker: str) -> None:
        if self.config.model_type == ModelType.BASE:
            logger.warning(
                "Using preset speaker %r on a Base model; Base models are "
                "trained for voice cloning — the output voice will be unpredictable.",
                speaker,
            )
        elif self.config.model_type == ModelType.VOICE_DESIGN:
            logger.warning("Using preset speaker %r on a VoiceDesign model.", speaker)

    def _session_inputs(self, options: SynthesisOptions, prefill_bucket: int):
        """Initial frame capacity, KV cache, and the uniform stream of the
        whole requested length (so growing the buffers never changes
        sampling)."""
        max_new_bucket = next_bucket(options.max_length, buckets=FRAME_BUCKETS)
        initial = min(max_new_bucket, GROWTH_INITIAL_FRAMES)
        return initial, self._new_cache(prefill_bucket, initial), self._uniforms(options.seed, max_new_bucket)

    @torch.no_grad()
    def _custom_voice_session(
        self, text: str, speaker: str, language: str, options: SynthesisOptions
    ) -> "StreamingSession":
        options = self._normalize_options(options)
        ids = self._encode_text(text)
        text_ids, text_len = self._pad_ids(ids)
        initial, cache, uniforms = self._session_inputs(options, CUSTOM_VOICE_PROMPT_LEN)
        started = prefill.custom_voice_impl(
            self.talker_params,
            self.config.talker,
            options.sampling_config(),
            text_ids,
            text_len,
            T.speaker_info(speaker).token_id,
            T.language_token_id(language),
            cache,
            uniforms,
            initial,
        )
        return self._make_session(started, options, uniforms)

    def _make_session(self, started, options: SynthesisOptions, uniforms: torch.Tensor) -> "StreamingSession":
        state, trailing, trailing_len, pad = started
        return StreamingSession(self, state, options.sampling_config(), options, trailing, trailing_len, pad,
                                uniforms)

    # ------------------------------------------------------------------
    # Public synthesis API
    # ------------------------------------------------------------------

    def synthesize(self, text: str, options: SynthesisOptions | None = None) -> AudioBuffer:
        return self.synthesize_with_voice(text, "ryan", "english", options)

    def synthesize_with_voice(
        self,
        text: str,
        speaker: str = "ryan",
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> AudioBuffer:
        """Synthesis with a preset speaker, chunk by chunk on the
        sample-exact streaming vocoder (``StreamingSession.run_to_audio``):
        the staged decode's audio up to matmul-tiling ulps. Use
        ``synthesize_with_timing`` for the staged per-phase breakdown."""
        self._warn_preset_speaker(speaker)
        session = self._custom_voice_session(text, speaker, language, options or SynthesisOptions())
        return session.run_to_audio()

    def synthesize_with_timing(
        self,
        text: str,
        speaker: str = "ryan",
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> tuple[AudioBuffer, SynthesisTiming]:
        """Staged synthesis (prefill, every frame, one bucketed decode) with
        host-clock times of the three stages (each ends in a device
        synchronise)."""
        self._warn_preset_speaker(speaker)
        t0 = time.perf_counter()
        session = self._custom_voice_session(text, speaker, language, options or SynthesisOptions())
        self._sync()
        t1 = time.perf_counter()
        frames = session.run_to_completion()
        t2 = time.perf_counter()
        audio = self.decode_codes(frames)
        t3 = time.perf_counter()
        timing = SynthesisTiming(
            prefill_ms=(t1 - t0) * 1e3,
            generation_ms=(t2 - t1) * 1e3,
            generation_frames=len(frames),
            decode_ms=(t3 - t2) * 1e3,
        )
        return audio, timing

    def synthesize_streaming(
        self,
        text: str,
        speaker: str = "ryan",
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> "StreamingSession":
        """A session to pull audio from chunk by chunk (``next_chunk``, or
        iterate it): 4 frames first, then ``chunk_frames`` a chunk."""
        return self._custom_voice_session(text, speaker, language, options or SynthesisOptions())

    # ------------------------------------------------------------------
    # Decode helpers
    # ------------------------------------------------------------------

    def codes_to_tensor(self, frames: np.ndarray) -> np.ndarray:
        """[T, 16] frame-major codes -> [1, 16, T] codebook-major."""
        return np.asarray(frames, np.int32).T[None]

    def decode_codes(self, frames: np.ndarray) -> AudioBuffer:
        """Decode [T, 16] frames to 24 kHz audio (bucketed, exact)."""
        frames = np.asarray(frames, np.int32)
        if frames.size == 0:
            return AudioBuffer(np.zeros(0, np.float32), T.OUTPUT_SAMPLE_RATE)
        wav = vocoder.decode_bucketed(
            self.vocoder_params, self.vocoder_config, self.codes_to_tensor(frames), bucket=DECODE_BUCKET
        )
        return AudioBuffer(wav[0], T.OUTPUT_SAMPLE_RATE)


def _pad_rows(t: torch.Tensor, delta: int) -> torch.Tensor:
    """``t`` [L, B, S, ...] with ``delta`` zero rows appended along S."""
    return torch.cat([t, t.new_zeros(t.shape[:2] + (delta,) + t.shape[3:])], dim=2)


class StreamingSession:
    """Pull-based streaming synthesis; also drives non-streaming synthesis.

    Holds the frame loop's state between chunks: each ``next_chunk``
    advances the loop by a chunk of frames and decodes only the new frames.
    The frames buffer and the talker cache start at ``GROWTH_INITIAL_FRAMES``
    frames and grow one ``FRAME_BUCKETS`` tier at a time (the streaming
    vocoder's KV cache with them); the uniform stream covers the whole
    requested length, so growth never changes a token.
    """

    def __init__(self, model: Qwen3TTS, state: core.GenState, scfg: sampling.SamplingConfig,
                 options: SynthesisOptions, trailing: torch.Tensor, trailing_len: int, pad_embed: torch.Tensor,
                 uniforms: torch.Tensor):
        self.model = model
        self.state = state
        self.scfg = scfg
        self.options = options
        self.trailing = trailing
        self.trailing_len = trailing_len
        self.pad_embed = pad_embed
        self.uniforms = uniforms
        self.frames_emitted = 0
        self._exhausted = False
        # Voice cloning's reference codes, decoded as vocoder context ahead
        # of the first chunk: not ported yet, so always None.
        self.prefix_codes: np.ndarray | None = None
        # The sample-exact streaming vocoder's carry (options.streaming_exact).
        self.vstate: vocoder.VocoderStreamState | None = None

    @property
    def frames_generated(self) -> int:
        return self.state.frame_idx

    def is_done(self) -> bool:
        return self._exhausted

    @torch.no_grad()
    def _advance(self, frame_limit: int) -> None:
        m = self.model
        self.state = core.generate_frames(
            m.talker_params, m.cp_params, m.config.talker, m.config.code_predictor, self.scfg, self.state,
            self.trailing, self.trailing_len, self.pad_embed, self.uniforms, frame_limit,
            m.cp_frame_pack, m.talker_step_pack, m.cp_step_pack,
        )

    @torch.no_grad()
    def _advance_and_decode_chunk(self, frame_limit: int, emitted: int, chunk: int):
        """One chunk of a stream with chunk-local vocoder context: advance the
        frame loop to ``frame_limit``, then decode the ``chunk`` frame rows from
        ``emitted`` (the start clamped so that the rows lie in the buffer, as
        the JAX package's dynamic slice clamps it). Rows past the frames made are
        zeros and the vocoder is causal, so trimming the samples to the true
        frame count is exact. The buffers grow first to hold ``frame_limit``
        frames. Returns (wav [1, chunk * 1920] on the device, frames made,
        done)."""
        self._grow_for(frame_limit)
        self._advance(frame_limit)
        s, m = self.state, self.model
        start = max(min(emitted, s.frames.shape[0] - chunk), 0)
        rows = s.frames[start:start + chunk]  # [chunk, 16]
        return vocoder.decode(m.vocoder_params, m.vocoder_config, rows.T[None]), s.frame_idx, bool(s.done)

    @torch.no_grad()
    def _advance_and_decode_chunk_exact(self, frame_limit: int, emitted: int, chunk: int):
        """One chunk of a stream on the sample-exact streaming vocoder: advance
        the frame loop to ``frame_limit``, then decode the ``chunk`` frame rows
        from ``emitted`` carrying ``self.vstate``. The frames buffer is padded
        with ``chunk`` zero rows so that the last, partial chunk's slice is
        whole. The buffers grow first to hold ``frame_limit`` frames, so the
        loop runs once (a second run would feed the stateful vocoder twice).
        Returns (wav [1, chunk * 1920] on the device, frames made, done)."""
        self._grow_for(frame_limit)
        self._ensure_vstate()
        self._advance(frame_limit)
        s, m = self.state, self.model
        frames_ext = torch.cat([s.frames, s.frames.new_zeros((chunk, s.frames.shape[1]))])
        rows = frames_ext[emitted:emitted + chunk]  # [chunk, 16]
        wav, self.vstate = vocoder.decode_stream_chunk(m.vocoder_params, m.vocoder_config, self.vstate, rows.T[None])
        return wav, s.frame_idx, bool(s.done)

    def _next_cap(self) -> int:
        """The frame capacity one tier up, at most the requested length's bucket."""
        cap = self.state.frames.shape[0]
        return min(next_bucket(cap + 1, buckets=FRAME_BUCKETS),
                   next_bucket(self.options.max_length, buckets=FRAME_BUCKETS))

    def _grow(self, new_cap: int) -> None:
        """Extend the frames buffer, the talker cache and the streaming
        vocoder's KV cache to ``new_cap`` frames (zero rows: rows past the
        loop's position are masked, so nothing computed changes)."""
        s = self.state
        delta = new_cap - s.frames.shape[0]
        s.frames = torch.cat([s.frames, s.frames.new_zeros((delta, s.frames.shape[1]))])
        s.cache = nn.KVCache(_pad_rows(s.cache.k, delta), _pad_rows(s.cache.v, delta))
        if self.vstate is not None:
            self.vstate = self.vstate._replace(kv_k=_pad_rows(self.vstate.kv_k, delta),
                                               kv_v=_pad_rows(self.vstate.kv_v, delta))

    def _grow_for(self, target: int) -> None:
        """Grow tier by tier until the buffers hold ``target`` frames (or the
        requested length's tier)."""
        while self.state.frames.shape[0] < target:
            new_cap = self._next_cap()
            if new_cap <= self.state.frames.shape[0]:
                return
            self._grow(new_cap)

    def _ensure_vstate(self) -> None:
        if self.vstate is None:
            self.vstate = vocoder.init_stream_state(self.model.vocoder_config, self.state.frames.shape[0],
                                                    device=self.model.device)

    def _advance_managed(self, target: int) -> tuple[int, bool]:
        """Advance to ``target`` total frames, growing the buffers a tier at a
        time only when the loop stops at a full one (a session that meets EOS
        early never holds the requested length's buffers). Returns (frames
        made, done)."""
        target = min(target, self.options.max_length)
        while True:
            self._advance(target)
            n, done = self.state.frame_idx, bool(self.state.done)
            if done or n >= target:
                return n, done
            self._grow_for(n + 1)  # stopped at a full buffer: one tier up

    def run_to_completion(self) -> np.ndarray:
        """Generate every remaining frame; returns [n, 16] int32."""
        n, _ = self._advance_managed(self.options.max_length)
        frames = self.state.frames[:n].cpu().numpy()
        self.frames_emitted = n
        self._exhausted = True
        return frames

    def run_to_audio(self) -> AudioBuffer:
        """Non-streaming synthesis as chunks of ``DECODE_BUCKET`` frames on
        the sample-exact streaming vocoder: the audio of
        ``decode_codes(frames)`` up to matmul-tiling ulps. With
        ``streaming_exact=False``, or once the session is exhausted: every
        frame, then one bucketed decode."""
        if not self.options.streaming_exact or self._exhausted:
            return self.model.decode_codes(self.run_to_completion())
        chunk, max_len = DECODE_BUCKET, self.options.max_length
        parts: list[np.ndarray] = []
        spec = self.frames_emitted
        total: int | None = None  # the true frame count once EOS or the limit is seen
        while spec < max_len and total is None:
            target = min(spec + chunk, max_len)
            wav, n, done = self._advance_and_decode_chunk_exact(target, spec, chunk)
            emitted_here = min(n, spec + chunk) - spec
            if emitted_here > 0:
                parts.append(wav[0, :emitted_here * T.SAMPLES_PER_FRAME].cpu().numpy())
            if done or n >= max_len:
                total = n
            spec = target
        self.frames_emitted = total if total is not None else spec
        self._exhausted = True
        return AudioBuffer(np.concatenate(parts) if parts else np.zeros(0, np.float32), T.OUTPUT_SAMPLE_RATE)

    def next_chunk(self) -> AudioBuffer | None:
        """Generate and decode the next chunk of frames (``first_chunk_frames``
        first, then ``chunk_frames``), or None when done.

        With ``streaming_exact`` (the default) the vocoder carries its causal
        state across chunks, so the chunks put together are the batch
        decode's audio; otherwise each chunk is decoded with chunk-local
        context only (the same number of samples).
        """
        if self._exhausted:
            return None
        chunk = max(self.options.chunk_frames, 1)
        if self.frames_emitted == 0 and self.options.first_chunk_frames:
            chunk = max(min(self.options.first_chunk_frames, chunk), 1)
        if self.options.streaming_exact:
            return self._next_chunk_exact(chunk)
        return self._next_chunk_legacy(chunk)

    def _dispatch_exact_ahead(self, chunk: int):
        """Run the next chunk at the frontier. The JAX package queues
        ``streaming_lookahead`` further chunks here; the port runs only the
        chunk asked for, so the chunk being returned never waits for work
        queued ahead of it."""
        target = min(self.frames_emitted + chunk, self.options.max_length)
        return self._advance_and_decode_chunk_exact(target, self.frames_emitted, chunk)

    def _next_chunk_exact(self, chunk: int) -> AudioBuffer | None:
        e0 = self.frames_emitted
        wav, n, done = self._dispatch_exact_ahead(chunk)
        done = done or n >= self.options.max_length
        if n <= e0:
            self._exhausted = True
            return None
        self.frames_emitted = n
        if done:
            self._exhausted = True
        # Rows past n were zero-code frames: decoded, their samples dropped.
        return AudioBuffer(wav[0, :(n - e0) * T.SAMPLES_PER_FRAME].cpu().numpy(), T.OUTPUT_SAMPLE_RATE)

    def _next_chunk_legacy(self, chunk: int) -> AudioBuffer | None:
        target = min(self.frames_emitted + chunk, self.options.max_length)
        wav, n, done = self._advance_and_decode_chunk(target, self.frames_emitted, chunk)
        done = done or n >= self.options.max_length
        if n <= self.frames_emitted:
            self._exhausted = True
            return None
        emitted_before, self.frames_emitted = self.frames_emitted, n
        if done:
            self._exhausted = True
        if emitted_before + chunk > self.state.frames.shape[0]:
            # The chunk's rows ran past the buffer, so the decoded slice was
            # moved back: decode the true rows on their own instead.
            new = self.state.frames[emitted_before:n].cpu().numpy()
            wavb = vocoder.decode_bucketed(self.model.vocoder_params, self.model.vocoder_config,
                                           self.model.codes_to_tensor(new), bucket=chunk)
            return AudioBuffer(wavb[0], T.OUTPUT_SAMPLE_RATE)
        return AudioBuffer(wav[0, :(n - emitted_before) * T.SAMPLES_PER_FRAME].cpu().numpy(), T.OUTPUT_SAMPLE_RATE)

    def __iter__(self):
        return self

    def __next__(self) -> AudioBuffer:
        chunk = self.next_chunk()
        if chunk is None:
            raise StopIteration
        return chunk
