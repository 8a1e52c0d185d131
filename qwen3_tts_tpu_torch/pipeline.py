"""Qwen3TTS facade: prompt -> prefill -> frame loop -> vocoder decode.

PyTorch port of the CustomVoice batch-1 path of ``qwen3_tts_tpu/pipeline.py``
(``synthesize``, ``synthesize_with_voice``, ``synthesize_with_timing``,
``decode_codes``, ``SynthesisOptions``, ``SynthesisTiming``). Synthesis runs
staged: prefill, then every frame, then one bucketed vocoder decode. The JAX
package's pipelined and streaming forms produce the same audio (its
streaming decode is sample-exact to the batch decode); they are not ported
yet, nor are voice cloning, voice design and batching. Weight-only int8
(``quantize_int8=True``) is ported.
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
    """Generation options; the defaults match the JAX package's.

    The JAX options for streaming, ICL voice cloning and speculative chunk
    dispatch are not ported yet.
    """

    max_length: int = 2048
    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.05
    eos_token_id: int = T.CODEC_EOS
    min_new_tokens: int = 2
    seed: int | None = None

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

    @torch.no_grad()
    def _prefill_custom_voice(self, text: str, speaker: str, language: str, options: SynthesisOptions):
        ids = self._encode_text(text)
        text_ids, text_len = self._pad_ids(ids)
        max_new = next_bucket(options.max_length, buckets=FRAME_BUCKETS)
        cache = self._new_cache(CUSTOM_VOICE_PROMPT_LEN, max_new)
        uniforms = self._uniforms(options.seed, max_new)
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
            max_new,
        )
        return started, uniforms

    @torch.no_grad()
    def _generate(self, started, uniforms: torch.Tensor, options: SynthesisOptions) -> np.ndarray:
        state, trailing, trailing_len, pad = started
        state = core.generate_frames(
            self.talker_params,
            self.cp_params,
            self.config.talker,
            self.config.code_predictor,
            options.sampling_config(),
            state,
            trailing,
            trailing_len,
            pad,
            uniforms,
            options.max_length,
            self.cp_frame_pack,
            self.talker_step_pack,
            self.cp_step_pack,
        )
        return state.frames[: state.frame_idx].cpu().numpy()

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
        """Staged synthesis with a preset speaker: prefill -> all frames ->
        one bucketed decode."""
        self._warn_preset_speaker(speaker)
        options = self._normalize_options(options or SynthesisOptions())
        started, uniforms = self._prefill_custom_voice(text, speaker, language, options)
        return self.decode_codes(self._generate(started, uniforms, options))

    def synthesize_with_timing(
        self,
        text: str,
        speaker: str = "ryan",
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> tuple[AudioBuffer, SynthesisTiming]:
        """As ``synthesize_with_voice``, with host-clock times of the three
        stages (each ends in a device synchronise)."""
        self._warn_preset_speaker(speaker)
        options = self._normalize_options(options or SynthesisOptions())
        t0 = time.perf_counter()
        started, uniforms = self._prefill_custom_voice(text, speaker, language, options)
        self._sync()
        t1 = time.perf_counter()
        frames = self._generate(started, uniforms, options)
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
