"""Qwen3TTS facade: prompt -> prefill -> frame loop -> vocoder decode.

PyTorch port of the batch-1 paths of ``qwen3_tts_tpu/pipeline.py``:
preset speakers (``synthesize``, ``synthesize_with_voice``,
``synthesize_with_timing``, ``synthesize_streaming``), voice design
(``synthesize_voice_design(_streaming)``: a ChatML-framed voice
description), and voice cloning of Base checkpoints
(``create_voice_clone_prompt``: the x-vector of the speaker encoder and,
given the reference text, the Mimi codes of the reference audio;
``synthesize_voice_clone(_streaming)``: an x-vector or ICL prompt), with
``decode_codes``, ``SynthesisOptions``, ``SynthesisTiming``,
``VoiceClonePrompt`` and ``StreamingSession``. Every synthesis runs through
a ``StreamingSession``: its buffers start at ``GROWTH_INITIAL_FRAMES``
frames and grow one ``FRAME_BUCKETS`` tier at a time between re-entries of
the frame loop. ``synthesize_with_voice`` decodes chunk by chunk on the
sample-exact streaming vocoder (``run_to_audio``),
``synthesize_with_timing`` runs the loop to its end, then one bucketed
decode, and the ``*_streaming`` entries hand the session to the caller
(``next_chunk`` / iteration). An ICL clone's reference codes advance the
streaming vocoder ahead of its first chunk and are cut from the audio.
Weight-only int8 (``quantize_int8=True``) is ported, and with it the
opt-in w8a8 of the batched programs (``int8_activations=True``).
``from_pretrained`` loads a Qwen3-TTS HF checkpoint directory with the
port's own safetensors reader and tokenizer (no ``safetensors`` or
``tokenizers`` package).
``synthesize_voice_clone_debug`` is the staged clone (every frame, then one
bucketed decode of [reference || frames] with the reference's share of the
samples cut). Throughput mode: ``synthesize_batch`` (B utterances, one
batched frame loop a prompt layout, one vocoder pass) and
``synthesize_streaming_batch`` (a ``StreamingBatchSession`` of one
layout, every stream a chunk at a time). Multi-GPU serving: ``shard(mesh)``
and ``from_pretrained(..., mesh=)`` place the model on a (dp, tp)
``parallel.sharding.Mesh``, and every entry point then runs on it.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import profiling
from .audio.io import AudioBuffer
from .audio.resample import resample_to_24k
from .generation import batch as gbatch
from .generation import core, prefill
from .models import code_predictor as cp
from .models import talker
from .models import tokens as T
from .models import weights as W
from .models.codec import vocoder
from .models.codec.encoder import Encoder12Hz, MimiEncoderConfig
from .models.config import ModelConfig, ModelType, config_for_variant, parse_config_json
from .models.speaker import SpeakerEncoder
from .ops import fused_layer, nn, quant, rng, sampling
from .parallel import collectives, sharding
from .tokenizer import TextTokenizer
from .utils.bucketing import next_bucket
from .utils.device import device_or_card

logger = logging.getLogger("qwen3_tts_tpu_torch")

FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)
TEXT_BUCKET = 32
DECODE_BUCKET = 64
CUSTOM_VOICE_PROMPT_LEN = 10
# Sessions start with this frame capacity and grow through FRAME_BUCKETS
# between re-entries of the frame loop, so decode attention reads the live
# tier's cache rows rather than the largest bucket's.
GROWTH_INITIAL_FRAMES = 256


@dataclass(frozen=True)
class SynthesisOptions:
    """Generation options; the defaults match the JAX package's."""

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
    # ICL prompt layout: False = element-wise overlay of the text and the
    # reference codec rows, True = sequential [text || codec] blocks.
    icl_sequential: bool = False
    # Sample-exact streaming: the vocoder carries its causal state across
    # chunks, so the streamed audio is the batch decode's. False = each
    # chunk decoded with chunk-local context only.
    streaming_exact: bool = True
    # Speculative dispatch-ahead: chunks queued on the device beyond the one
    # being returned (a chunk queued past EOS is frozen and discarded), so
    # the card works on chunk k+1 while the host copies chunk k. Every value
    # gives the same chunks.
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


@dataclass
class VoiceClonePrompt:
    """Reference-audio conditioning (x-vector, plus ICL codes and text if given)."""

    speaker_embedding: np.ndarray  # [enc_dim] float32
    ref_codes: np.ndarray | None = None  # [T, 16] int32 (ICL mode)
    ref_text_ids: list[int] | None = None  # tokenized reference text (ICL mode)


# ICL-mode generation overrides: the repetition penalty at least this, and
# max_length at most max(ICL_MIN_FRAMES, ICL_FRAMES_PER_TOKEN * text tokens).
ICL_MIN_FRAMES = 75
ICL_FRAMES_PER_TOKEN = 6
ICL_MIN_REPETITION_PENALTY = 1.5


def _sidecar_config(path: Path, cls):
    """A dataclass config from a JSON sidecar file, or None if it is absent.

    Unknown keys are rejected (typo safety); JSON lists become tuples (e.g.
    the Mimi ratios).
    """
    if not path.exists():
        return None
    data = json.loads(path.read_text())
    unknown = set(data) - {f.name for f in fields(cls)}
    if unknown:
        raise ValueError(f"{path}: unknown {cls.__name__} fields {sorted(unknown)}")
    logger.info("Loaded %s override from %s", cls.__name__, path)
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in data.items()})


class Qwen3TTS:
    """End-to-end TTS on one device (a CUDA card, or the CPU): preset
    speakers, voice cloning and voice design.

    The code predictor's layer weights are kept fused (q|k|v, gate|up): the
    frame kernel takes that layout. On a CUDA card the talker is fused too,
    once, here: its decode steps then run the whole-step talker kernel on
    plain weights (the JAX package's plain stream pack, without its [H, H]
    tile re-layout), and the separate projections are dropped. On the CPU
    the talker keeps the separate projections, as the JAX package's main
    path does (a talker tree handed in fused stays fused). Prefill runs the
    layer path on either tree; on the card the model also holds a
    ``talker.PrefillGraph`` (``prefill_graph``), and the batch-1 prefill of
    a 10-row prompt (CustomVoice, x-vector clone) replays that CUDA graph.

    ``quantize_int8=True``: weight-only int8, as the JAX package's (without
    its [H, H] stream-tile re-layout). The talker and the code predictor are
    fused (unless already), then their layer projections, the codec head and
    the lm heads are quantized; decode steps then run the whole-step talker
    kernel and the int8 code-predictor frame (or, for a code predictor the
    frame kernel does not take, its per-step kernels:
    ``models/code_predictor``), the prefill and codec head the W8A16 matmul.

    On the card, a code predictor that takes the frame kernel gets its
    ``fused_layer.CpFramePack`` here (one that takes kernel 7 per step its
    ``fused_layer.CpStepPack``, one that takes kernels 5 + 6 its
    ``fused_layer.FusedStepPack``, both as ``cp_step_pack``), and the fused
    talker its
    ``fused_layer.TalkerStepPack`` (each checked, packed and given its
    scratch once); every frame of this model uses them, on the stream of
    the first. A code predictor built with ``decode_mode="jacobi"`` gets no
    pack: every frame loop runs its Jacobi iterations (kernel 4 on an int8
    tree), never kernel 1 or a per-step kernel.

    ``int8_activations=True`` (with ``quantize_int8`` only, else it raises):
    w8a8 in the batched programs (``synthesize_batch``,
    ``synthesize_streaming_batch``: their prefills and frame loops run
    under ``quant.w8a8_scope``), activations quantized per row and an exact
    int8 x int8 product; lossy by design, so coalesced output is not
    bit-identical to solo decode. The batch-1 entry points never take it:
    they stay weight-only int8, bit for bit.

    ``speaker_encoder`` (``models.speaker.SpeakerEncoder``) and
    ``speech_encoder`` (``models.codec.encoder.Encoder12Hz``) are a Base
    checkpoint's: voice cloning needs the first, ICL cloning both. They run
    in f32 on the device that holds their weights.

    ``from_pretrained``, ``from_random`` and ``from_numpy`` build on the CUDA
    card unless given ``device="cpu"``; ``shard`` (or ``from_pretrained(...,
    mesh=)``) then spreads the model over a (dp, tp) mesh.
    """

    def __init__(
        self,
        config: ModelConfig,
        talker_params: dict,
        cp_params: dict,
        vocoder_params: dict,
        tokenizer=None,
        speaker_encoder: SpeakerEncoder | None = None,
        speech_encoder: Encoder12Hz | None = None,
        vocoder_config: vocoder.VocoderConfig = vocoder.VocoderConfig(),
        quantize_int8: bool = False,
        int8_activations: bool = False,
    ):
        if int8_activations and not quantize_int8:
            raise ValueError("int8_activations requires quantize_int8=True")
        self.config = config
        self.w8a8 = bool(int8_activations)
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
        self.cp_frame_pack, self.cp_step_pack = self._cp_packs(cp_params, self.device)
        self.talker_step_pack = None
        layers, stack = talker_params["layers"], config.talker.layer_stack()
        if (on_card and fused_layer.has_stream_pack(layers, stack.hidden_size)
                and fused_layer.supports_talker_step_kernel(layers, stack, fused_layer.TALKER_STREAM_MAX_SEQ)):
            self.talker_step_pack = fused_layer.TalkerStepPack(layers, stack, self.compute_dtype, self.device)
        # The batch-1 prefill of the 10-row prompts as one CUDA graph, captured at its first replay.
        self.prefill_graph = (talker.PrefillGraph(talker_params, config.talker, CUSTOM_VOICE_PROMPT_LEN)
                              if on_card else None)
        self.vocoder_params = vocoder_params
        self.vocoder_config = vocoder_config
        self.tokenizer = tokenizer
        self.speaker_encoder = speaker_encoder
        self.speech_encoder = speech_encoder
        # Multi-GPU serving (``shard``): the mesh, every dp replica's trees,
        # and replica 0's ranks' kernel-5/6 packs.
        self.mesh: sharding.Mesh | None = None
        self.replicas: list[Replica] = []
        self.tp_step_packs: list | None = None

    def _cp_packs(self, cp_params: dict, dev: torch.device) -> tuple:
        """The code predictor's kernel pack on a card for the route it takes
        (``cp.cp_route``, which raises on an unknown decode_mode): (frame pack,
        per-step pack), either or both None."""
        route = cp.cp_route(cp_params, self.config.code_predictor)
        if dev.type != "cuda":
            return None, None
        if route == "frame":
            return fused_layer.CpFramePack(cp_params, self.config.code_predictor, self.compute_dtype, dev), None
        if route in ("streamed_step", "layer_steps"):
            step_pack = fused_layer.CpStepPack if route == "streamed_step" else fused_layer.FusedStepPack
            return None, step_pack(cp_params["layers"], self.config.code_predictor.layer_stack(), self.compute_dtype,
                                   dev)
        return None, None

    # ------------------------------------------------------------------
    # Multi-GPU serving
    # ------------------------------------------------------------------

    @torch.no_grad()
    def shard(self, mesh: sharding.Mesh) -> "Qwen3TTS":
        """Place the model on a (dp, tp) ``mesh`` (``parallel.sharding.make_mesh``)
        for tensor- and data-parallel serving; returns self, with
        ``self.mesh`` set. Every entry point then runs on the mesh unchanged.

        * The talker splits over each replica's tp ranks by
          ``sharding.talker_specs`` (heads, intermediate and the codec head's
          vocabulary on tp; a fused projection block by block; embeddings and
          norms whole): ``self.talker_params`` becomes replica 0's
          ``sharding.ShardedTree``, and its layer path the tensor-parallel
          one (``nn.run_layer_stack_tp``, kernel 4 per rank on an int8 tree).
          tp must divide the heads, the KV heads, the intermediate, the text
          projection's intermediate and the codec vocabulary.
        * The whole-step talker kernel's pack and the prefill graph are
          dropped (kernel 3 and a graph cannot span ranks), as the JAX
          package drops its stream pack. An int8
          talker at tp > 1 gets the head-aligned re-layout
          (``fused_layer.make_tp_pack``, each rank's chunk serving as its
          fused qkv and gate|up) and, on the cards, each rank of replica 0
          its own kernel-5/6 pack (``fused_layer.tp_step_packs``): its
          batch-1 decode steps run kernels 5 and 6 on every rank with an
          all-reduce between them (``fused_layer.tp_decode_step``).
        * The code predictor is not split: each replica holds it whole on its
          first device, replica 0 with its single-card kernel pack (kernel 1,
          or its per-step route). This departs from the JAX package, which
          shards it too, with the same results: kernel 1 cannot span cards,
          and the 1.7B code predictor is about 0.16 GB of bf16 layer weights.
        * Batch-1 synthesis runs on replica 0; ``synthesize_batch`` and
          ``synthesize_streaming_batch`` split a batch's streams over the dp
          replicas (``_split_batch``). The vocoder decodes on replica 0's
          first device, where every frame comes back.
        * On distinct cards the ranks' collectives are NCCL's, their
          communicators made here; ranks that share a device add locally
          (``parallel.collectives``).

        A second, unsharded model in the process keeps its packs and kernels.
        """
        if self.mesh is not None:
            raise RuntimeError("shard(): the model is already sharded")
        tcfg, tp = self.config.talker, mesh.shape["tp"]
        stack = tcfg.layer_stack()
        nn.tp_local_config(stack, tp)  # raises unless tp divides the heads and the intermediate
        for name, width in (("text projection intermediate", tcfg.text_proj_intermediate),
                            ("codec vocabulary", tcfg.codec_vocab_size)):
            if width % tp:
                raise ValueError(f"shard(): tp={tp} does not divide the {name} ({width})")
        tree = dict(self.talker_params)
        tpack = fused_layer.make_tp_pack(tree["layers"], stack, tp) if tp > 1 else None
        if tpack is not None:
            tree["tp_pack"] = tpack
        ranks = sharding.shard_pytree(tree, sharding.talker_specs(tcfg, tree), mesh)
        if tpack is not None:
            # A rank's tp-pack chunk is its block slice of the fused tree: one copy serves both.
            for rank in (r for row in ranks for r in row):
                rank["layers"] = dict(rank["layers"], qkv_proj=rank["tp_pack"]["qkv"],
                                      gateup_proj=rank["tp_pack"]["gu"])
        del tree, tpack
        self.talker_step_pack = self.prefill_graph = None
        self.replicas = []
        for r in range(mesh.shape["dp"]):
            dev = mesh.first(r)
            collectives.connect(mesh.replica(r))
            self.replicas.append(Replica(sharding.ShardedTree(ranks[r], mesh.replica(r)),
                                         sharding.place_pytree(self.cp_params, dev), dev))
        first = self.replicas[0]
        self.talker_params, self.cp_params, self.device = first.talker_params, first.cp_params, first.device
        with collectives.device_scope(self.device):
            self.cp_frame_pack, self.cp_step_pack = self._cp_packs(self.cp_params, self.device)
            self.vocoder_params = sharding.place_pytree(self.vocoder_params, self.device)
        if "tp_pack" in self.talker_params and self.device.type == "cuda":
            self.tp_step_packs = fused_layer.tp_step_packs(
                [r["layers"] for r in first.talker_params.ranks], [r["tp_pack"] for r in first.talker_params.ranks],
                stack, self.compute_dtype, first.talker_params.devices)
        self.mesh = mesh
        logger.info("shard(): %s; talker decode steps on %s", mesh,
                    "kernels 5 + 6 per rank" if "tp_pack" in self.talker_params else "the tensor-parallel layer path")
        return self

    def _place_cache(self, cache: nn.KVCache) -> nn.KVCache | nn.TPCache:
        """A batch-1 cache split over replica 0's ranks by KV heads
        (``sharding.serving_cache_spec``), if the model is sharded."""
        if self.mesh is None:
            return cache
        return _split_cache(cache, sharding.serving_cache_spec(), self.mesh.replica_mesh(0))[0]

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str | Path,
        tokenizer_id: str | Path | None = None,
        vocoder_config: vocoder.VocoderConfig | None = None,
        mimi_config: MimiEncoderConfig | None = None,
        dtype: torch.dtype = torch.bfloat16,
        quantize_int8: bool = False,
        device: torch.device | str | None = None,
        int8_activations: bool = False,
        mesh: sharding.Mesh | None = None,
    ) -> "Qwen3TTS":
        """Load a local HF checkpoint directory (config.json +
        model.safetensors + speech_tokenizer/model.safetensors, and the text
        tokenizer's files) onto ``device``: the CUDA card by default, or
        ``device="cpu"``.

        ``vocoder_config`` / ``mimi_config`` default to the production 12 Hz
        speech tokenizer's dimensions, or to ``vocoder_config.json`` /
        ``mimi_config.json`` sidecars in ``model_dir`` (unknown keys
        rejected). Without config.json the variant is sniffed from the
        weights (talker hidden 2048 -> 1.7B, else 0.6B; Base). The speech
        tokenizer is looked for in ``model_dir/speech_tokenizer/``, then in
        ``model_dir.parent/speech_tokenizer/``; the text tokenizer in
        ``tokenizer_id`` or ``model_dir``. ``dtype`` is the talker and code
        predictor's compute dtype (bf16; f32 for numerics against the JAX
        package on the CPU); the vocoder and the encoders stay f32. The
        speaker encoder is built when the checkpoint has ``speaker_encoder.*``
        tensors, the Mimi encoder when the speech tokenizer has ``encoder.*``
        tensors; an incomplete or malformed ``encoder.*`` set (``KeyError``,
        ``ValueError``) leaves it None (no ICL cloning), any other error
        raises. ``int8_activations`` (with ``quantize_int8``): w8a8 in the
        batched programs, as in ``Qwen3TTS``. ``mesh``: a
        ``parallel.sharding.Mesh``; the model loads on its first device (unless
        ``device`` says otherwise) and is sharded on it (``shard``).
        """
        if device is None and mesh is not None:
            device = mesh.first(0)
        device = device_or_card(device)
        model_dir = Path(model_dir)
        if vocoder_config is None:
            vocoder_config = _sidecar_config(model_dir / "vocoder_config.json", vocoder.VocoderConfig)
        if mimi_config is None:
            mimi_config = _sidecar_config(model_dir / "mimi_config.json", MimiEncoderConfig)
        vocoder_config = vocoder_config or vocoder.VocoderConfig()
        raw = W.load_safetensors(model_dir / "model.safetensors", device)

        config_path = model_dir / "config.json"
        if config_path.exists():
            config = parse_config_json(config_path)
        else:
            hidden = raw["talker.model.norm.weight"].shape[0]
            config = config_for_variant("1.7B" if hidden == 2048 else "0.6B", "base")

        st_path = model_dir / "speech_tokenizer" / "model.safetensors"
        if not st_path.exists():
            alt = model_dir.parent / "speech_tokenizer" / "model.safetensors"
            if not alt.exists():
                raise FileNotFoundError("Speech tokenizer weights not found")
            st_path = alt
        st_raw = W.load_safetensors(st_path, device)

        tokenizer = TextTokenizer.from_pretrained(tokenizer_id or model_dir)
        talker_params = W.load_talker_params(raw, config.talker, dtype)
        cp_params = W.load_code_predictor_params(raw, config.code_predictor, dtype)
        vocoder_params = vocoder.load_vocoder_params(st_raw, vocoder_config)

        speaker = None
        if any(k.startswith("speaker_encoder.") for k in raw):
            speaker = SpeakerEncoder.from_weights(raw, config.speaker_encoder)
        speech = None
        if any(k.startswith("encoder.") for k in st_raw):
            try:
                speech = Encoder12Hz.from_weights(st_raw, mimi_config or MimiEncoderConfig())
            except (KeyError, ValueError) as e:
                logger.warning("Speech encoder not built (%s: %s); ICL voice cloning is unavailable.",
                               type(e).__name__, e)
        del raw, st_raw
        model = cls(config, talker_params, cp_params, vocoder_params, tokenizer, speaker, speech,
                    vocoder_config=vocoder_config, quantize_int8=quantize_int8, int8_activations=int8_activations)
        return model.shard(mesh) if mesh is not None else model

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
        default device is the CUDA card; ``device="cpu"`` builds on the CPU.
        No encoders, as in the JAX package."""
        device = device_or_card(device)
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
        speaker_tree: dict | None = None,
        mimi_tree: dict | None = None,
        mimi_config: MimiEncoderConfig = MimiEncoderConfig(),
    ) -> "Qwen3TTS":
        """A model from a JAX model's parameter trees converted to numpy
        (``jax.tree.map(np.asarray, model.talker_params)`` etc.), on
        ``device``: the CUDA card by default, or ``device="cpu"``.
        ``speaker_tree`` / ``mimi_tree``: the JAX package's speaker-encoder
        and Mimi-encoder trees (``SpeakerEncoder.params``,
        ``Encoder12Hz.params``) as numpy, for a model that clones."""
        device = device_or_card(device)
        speaker = speech = None
        if speaker_tree is not None:
            speaker = SpeakerEncoder(W.speaker_encoder_from_numpy(speaker_tree, device), config.speaker_encoder)
        if mimi_tree is not None:
            speech = Encoder12Hz(W.mimi_encoder_from_numpy(mimi_tree, device), mimi_config)
        return cls(
            config,
            W.from_numpy_tree(talker_tree, device),
            W.from_numpy_tree(cp_tree, device),
            W.from_numpy_tree(vocoder_tree, device),
            tokenizer,
            speaker,
            speech,
            vocoder_config=vocoder_config,
            quantize_int8=quantize_int8,
        )

    # -- capability probes --

    @property
    def model_type(self) -> ModelType:
        return self.config.model_type

    def supports_voice_cloning(self) -> bool:
        return self.speaker_encoder is not None

    def supports_preset_speakers(self) -> bool:
        return self.config.model_type == ModelType.CUSTOM_VOICE

    def supports_voice_design(self) -> bool:
        return self.config.model_type == ModelType.VOICE_DESIGN

    def has_speech_encoder(self) -> bool:
        return self.speech_encoder is not None

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
        return self._place_cache(nn.init_kv_cache(self.config.talker.layer_stack(), 1, rows, self.compute_dtype,
                                                  self.device))

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
        request = profiling.new_request()
        with profiling.annotate("q3.open", request):
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
                graph=self.prefill_graph,
            )
            return self._make_session(started, options, uniforms, request)

    @torch.no_grad()
    def _voice_design_session(
        self, text: str, instruct: str, language: str, options: SynthesisOptions
    ) -> "StreamingSession":
        request = profiling.new_request()
        with profiling.annotate("q3.open", request):
            options = self._normalize_options(options)
            text_ids, text_len = self._pad_ids(self._encode_text(text))
            # The voice description in a ChatML user turn.
            instruct_ids, instruct_len = self._pad_ids(self._encode_text(f"<|im_start|>user\n{instruct}<|im_end|>\n"))
            initial, cache, uniforms = self._session_inputs(options, instruct_ids.shape[0] + 9)
            started = prefill.voice_design_impl(
                self.talker_params, self.config.talker, options.sampling_config(), text_ids, text_len,
                instruct_ids, instruct_len, T.language_token_id(language), cache, uniforms, initial,
                graph=self.prefill_graph,
            )
            return self._make_session(started, options, uniforms, request)

    @torch.no_grad()
    def _voice_clone_session(
        self, text: str, prompt_data: VoiceClonePrompt, language: str, options: SynthesisOptions
    ) -> "StreamingSession":
        """A cloning session; in ICL mode its ``prefix_codes`` are the
        reference codes, and the overrides apply before the uniforms are
        drawn: repetition penalty at least ``ICL_MIN_REPETITION_PENALTY``,
        ``max_length`` at most max(``ICL_MIN_FRAMES``,
        ``ICL_FRAMES_PER_TOKEN`` x text tokens)."""
        request = profiling.new_request()
        with profiling.annotate("q3.open", request):
            options = self._normalize_options(options)
            ids = self._encode_text(text)
            is_icl = prompt_data.ref_codes is not None and prompt_data.ref_text_ids is not None
            if is_icl:
                options = replace(
                    options,
                    repetition_penalty=max(options.repetition_penalty, ICL_MIN_REPETITION_PENALTY),
                    max_length=min(options.max_length, max(ICL_MIN_FRAMES, len(ids) * ICL_FRAMES_PER_TOKEN)),
                )
            # The x-vector in the compute dtype (bf16 on the bf16 path).
            speaker_vec = torch.as_tensor(np.asarray(prompt_data.speaker_embedding), device=self.device).to(
                self.compute_dtype)
            lang_id = T.language_token_id(language)

            if not is_icl:
                text_ids, text_len = self._pad_ids(ids)
                initial, cache, uniforms = self._session_inputs(options, CUSTOM_VOICE_PROMPT_LEN)
                started = prefill.voice_clone_xvector_impl(
                    self.talker_params, self.config.talker, options.sampling_config(), text_ids, text_len,
                    speaker_vec, lang_id, cache, uniforms, initial, graph=self.prefill_graph,
                )
                return self._make_session(started, options, uniforms, request)

            # ICL: prompt = [voice clone (9 rows) || ICL rows].
            ref_codes = np.asarray(prompt_data.ref_codes, np.int32)  # [Tr, 16]
            t_ref = ref_codes.shape[0]
            all_text, n_text = self._pad_ids(list(prompt_data.ref_text_ids) + list(ids) + [T.TTS_EOS])
            codec_rows = self._sum_ref_codec_embeddings(ref_codes)  # [Tr, hidden]
            cb = next_bucket(t_ref + 1, TEXT_BUCKET)
            codec_padded = codec_rows.new_zeros((cb, codec_rows.shape[-1]))
            codec_padded[:1] = talker.embed_codec(self.talker_params, torch.tensor([T.CODEC_BOS], device=self.device))
            codec_padded[1:t_ref + 1] = codec_rows
            prefill_bucket = 9 + cb + (all_text.shape[0] if options.icl_sequential else 0)
            initial, cache, uniforms = self._session_inputs(options, prefill_bucket)
            started = prefill.voice_clone_icl_impl(
                self.talker_params, self.config.talker, options.sampling_config(), all_text, n_text, speaker_vec,
                codec_padded, t_ref + 1, lang_id, cache, uniforms, initial, sequential=options.icl_sequential,
                graph=self.prefill_graph,
            )
            session = self._make_session(started, options, uniforms, request)
            session.prefix_codes = ref_codes
            return session

    def _sum_ref_codec_embeddings(self, ref_codes: np.ndarray) -> torch.Tensor:
        """[T, 16] codes -> [T, hidden]: the talker's codec embedding of
        group 0 plus the code predictor's 15 group embeddings."""
        codes = torch.from_numpy(np.asarray(ref_codes, np.int64)).to(self.device)
        semantic = talker.embed_codec(self.talker_params, codes[:, 0])
        tables = self.cp_params["codec_embeddings"]  # [15, V, dim]
        groups = torch.arange(tables.shape[0], device=self.device)[:, None]
        return semantic + tables[groups, codes[:, 1:].T].sum(dim=0)

    def _make_session(self, started, options: SynthesisOptions, uniforms: torch.Tensor,
                      request: int | None = None) -> "StreamingSession":
        state, trailing, trailing_len, pad = started
        return StreamingSession(self, state, options.sampling_config(), options, trailing, trailing_len, pad,
                                uniforms, request)

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

    def synthesize_voice_design(
        self,
        text: str,
        instruct: str,
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> AudioBuffer:
        """Synthesis with a voice described in words (``instruct``), as
        ``synthesize_with_voice`` runs it (``run_to_audio``)."""
        if self.config.model_type != ModelType.VOICE_DESIGN:
            logger.warning("VoiceDesign synthesis on a %s model; the output may be unpredictable.",
                           self.config.label)
        session = self._voice_design_session(text, instruct, language, options or SynthesisOptions())
        return session.run_to_audio()

    def synthesize_voice_design_streaming(
        self,
        text: str,
        instruct: str,
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> "StreamingSession":
        return self._voice_design_session(text, instruct, language, options or SynthesisOptions())

    def create_voice_clone_prompt(
        self,
        ref_audio: AudioBuffer,
        ref_text: str | None = None,
        pad_to_seconds: float | None = None,
    ) -> VoiceClonePrompt:
        """X-vector (and, given ``ref_text``, ICL) conditioning from reference
        audio, resampled to 24 kHz first if it is at another rate.

        ``pad_to_seconds``: the JAX package's legacy knob; the audio is
        zero-padded to a whole number of ``pad_to_seconds`` units (at least
        one) before both encoders. It dilutes the pooled x-vector a little;
        the default None encodes the audio as it is."""
        if self.speaker_encoder is None:
            hint = {
                ModelType.CUSTOM_VOICE: " CustomVoice models use preset speakers; use a Base model for cloning.",
                ModelType.VOICE_DESIGN: " VoiceDesign models use text-described voices; use a Base model for cloning.",
            }.get(self.config.model_type, " Only Base checkpoints include a speaker encoder.")
            raise RuntimeError("Speaker encoder not available." + hint)
        with profiling.annotate("q3.clone_prompt") as span:
            if ref_audio.sample_rate != T.OUTPUT_SAMPLE_RATE:
                ref_audio = resample_to_24k(ref_audio)
            if pad_to_seconds:
                unit = int(pad_to_seconds * T.OUTPUT_SAMPLE_RATE)
                padded = np.zeros(max(-(-len(ref_audio.samples) // unit) * unit, unit), np.float32)
                padded[:len(ref_audio.samples)] = ref_audio.samples
                ref_audio = AudioBuffer(padded, T.OUTPUT_SAMPLE_RATE)
            span.set("samples", len(ref_audio.samples))
            span.set("icl", int(ref_text is not None))
            speaker_embedding = self.speaker_encoder.encode(ref_audio.samples)
            ref_codes = ref_text_ids = None
            if ref_text is not None:
                if self.speech_encoder is None:
                    raise RuntimeError(
                        "ICL voice cloning requires the speech encoder; pass ref_text=None for x-vector-only cloning."
                    )
                ref_codes = self.speech_encoder.encode(ref_audio.samples)
                ref_text_ids = self._encode_text(ref_text)
            return VoiceClonePrompt(np.asarray(speaker_embedding), ref_codes, ref_text_ids)

    def synthesize_voice_clone(
        self,
        text: str,
        prompt: VoiceClonePrompt,
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> AudioBuffer:
        """Cloning as ``synthesize_with_voice`` runs it (``run_to_audio``). In
        ICL mode the reference codes advance the streaming vocoder as
        context that is not emitted: the batch decode of [reference ||
        frames] with the reference's samples (1920 a frame) cut."""
        return self._voice_clone_session(text, prompt, language, options or SynthesisOptions()).run_to_audio()

    def synthesize_voice_clone_streaming(
        self,
        text: str,
        prompt: VoiceClonePrompt,
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> "StreamingSession":
        """A cloning session to pull audio from chunk by chunk; in ICL mode
        the reference codes are decoded as vocoder context ahead of the
        first chunk and cut from the output."""
        return self._voice_clone_session(text, prompt, language, options or SynthesisOptions())

    def synthesize_voice_clone_debug(
        self,
        text: str,
        prompt: VoiceClonePrompt,
        language: str = "english",
        options: SynthesisOptions | None = None,
    ) -> tuple[AudioBuffer, np.ndarray]:
        """Staged cloning: every frame, then one bucketed decode; returns
        (audio, frames [T, 16]). In ICL mode the decode is of [reference
        codes || frames], and the reference's share of the samples
        (proportional to its frames) is cut from the front."""
        session = self._voice_clone_session(text, prompt, language, options or SynthesisOptions())
        frames = session.run_to_completion()
        return self._decode_behind(session._prefix(), frames), frames

    # ------------------------------------------------------------------
    # Batched synthesis (throughput mode)
    # ------------------------------------------------------------------

    @staticmethod
    def _split_batch_groups(voices: list, instructs: list[str | None]) -> list[tuple[str, list[int]]]:
        """Partition batch indices by prompt layout: ``basic`` (the 10-row
        prompt: preset speakers and x-vector ``VoiceClonePrompt``s, whose
        speaker row is a vector either way), ``icl`` (prompts with reference
        codes and text: 9 rows + the reference rows, and the ICL overrides)
        and ``design`` (an instruct given: instruct rows + 9). Each group runs
        as one batched loop; the order is that of first appearance."""
        groups: dict[str, list[int]] = {}
        for i, (v, ins) in enumerate(zip(voices, instructs)):
            if ins is not None:
                kind = "design"
            elif isinstance(v, VoiceClonePrompt) and v.ref_codes is not None and v.ref_text_ids is not None:
                kind = "icl"
            else:
                kind = "basic"
            groups.setdefault(kind, []).append(i)
        return list(groups.items())

    def _batch_args(self, texts: list[str], speakers, languages, options: SynthesisOptions | None,
                    seeds: list[int] | None, instructs: list[str | None] | None):
        """The batched entries' arguments, one of each a stream; seeds
        default to ``options.seed + i`` (``options.seed`` None counts as 0)."""
        options = self._normalize_options(options or SynthesisOptions())
        b = len(texts)
        if isinstance(speakers, (str, VoiceClonePrompt)):
            speakers = [speakers] * b
        if isinstance(languages, str):
            languages = [languages] * b
        if instructs is None:
            instructs = [None] * b
        if seeds is None:
            base_seed = options.seed if options.seed is not None else 0
            seeds = [base_seed + i for i in range(b)]
        return options, list(speakers), list(languages), list(instructs), list(seeds)

    def synthesize_batch(
        self,
        texts: list[str],
        speakers: list | str = "ryan",
        languages: list[str] | str = "english",
        options: SynthesisOptions | None = None,
        seeds: list[int] | None = None,
        instructs: list[str | None] | None = None,
    ) -> list[AudioBuffer]:
        """Throughput mode: B utterances through one batched frame loop a
        prompt layout, then one vocoder pass for all of them.

        Every frame reads the talker's and the code predictor's weights once
        for all B streams. Stream i uses ``seeds[i]`` (default
        ``options.seed + i``) and gives its batch-1 output's frames.
        ``speakers`` entries are preset-speaker names or
        ``VoiceClonePrompt``s (x-vector or ICL cloning); ``instructs[i]``
        makes stream i a voice design. Streams are grouped by prompt layout
        (``_split_batch_groups``); a homogeneous batch is one loop. The
        batched loop runs the layer path (never kernels 1 and 3, which are
        batch-1); the vocoder decodes all streams in one bucketed pass, ICL
        streams behind their reference codes (cut at ``ref_len * 1920``
        samples). On a sharded model a group's streams split over the dp
        replicas (``_split_batch``), which advance in lock-step: a frame of
        every replica a round, one look at the device for the group.

        On an H100 this is slower today than calling the batch-1 entry
        points once a text, at B = 8 too: the batched loop is the eager
        layer path, whose ~8,400 kernel launches a frame keep the host busy
        while the device idles (``synthesis_timing.py --cells
        profile-batch8-bf16``). Behind the HTTP server (``chip_smoke.py``
        phase ``server``, NVIDIA H100 80GB HBM3 at 700 W), 8 coalesced
        32-frame bf16 requests took 4.1-6.9 s each, 37-62 frames/s in all,
        where the same 8 sent one after another took 0.27-0.31 s each,
        110-120 frames/s. Capturing its frame body in a CUDA graph is the
        remedy still to come."""
        return self.synthesize_batch_with_timing(texts, speakers, languages, options, seeds, instructs)[0]

    @torch.no_grad()
    def synthesize_batch_with_timing(
        self,
        texts: list[str],
        speakers: list | str = "ryan",
        languages: list[str] | str = "english",
        options: SynthesisOptions | None = None,
        seeds: list[int] | None = None,
        instructs: list[str | None] | None = None,
    ) -> tuple[list[AudioBuffer], SynthesisTiming]:
        """``synthesize_batch`` with host-clock stage times (each stage ends
        in a device synchronise): prefill and the frame loop summed over the
        layout groups, ``generation_frames`` the most frames of any stream,
        and the one vocoder pass."""
        options, speakers, languages, instructs, seeds = self._batch_args(
            texts, speakers, languages, options, seeds, instructs)
        b = len(texts)
        frames_all: list[np.ndarray | None] = [None] * b
        counts = np.zeros(b, np.int64)
        refs_all: list[np.ndarray | None] = [None] * b
        timing = SynthesisTiming()
        for kind, idx in self._split_batch_groups(speakers, instructs):
            t0 = time.perf_counter()
            group = self._prepare_batch_group(kind, [texts[i] for i in idx], [speakers[i] for i in idx],
                                              [languages[i] for i in idx], [instructs[i] for i in idx], options,
                                              [seeds[i] for i in idx])
            self._sync()
            t1 = time.perf_counter()
            frames_g, counts_g = self._generate_batch_group(group)
            t2 = time.perf_counter()
            timing.prefill_ms += (t1 - t0) * 1e3
            timing.generation_ms += (t2 - t1) * 1e3
            for j, i in enumerate(idx):
                frames_all[i], counts[i], refs_all[i] = frames_g[j], counts_g[j], group.refs[j]
        timing.generation_frames = int(counts.max()) if b else 0
        t0 = time.perf_counter()
        audio = self._decode_batch(frames_all, counts, refs_all)
        timing.decode_ms = (time.perf_counter() - t0) * 1e3
        return audio, timing

    def _decode_batch(self, frames_all: list, counts: np.ndarray, refs_all: list) -> list[AudioBuffer]:
        """One bucketed vocoder pass over every stream at the most combined
        frames; ICL streams prepend their reference codes and are cut at
        exactly ``ref_len * 1920`` samples. The vocoder is causal and the
        padded frames are zeros, so each stream's trim is exact."""
        b = len(frames_all)
        ref_lens = np.array([0 if r is None else len(r) for r in refs_all], np.int64)
        totals = ref_lens + counts
        t_max = int(totals.max()) if b else 0
        if t_max == 0:
            return [AudioBuffer(np.zeros(0, np.float32), T.OUTPUT_SAMPLE_RATE) for _ in range(b)]
        codes = np.zeros((b, t_max, T.NUM_CODE_GROUPS), np.int32)
        for i in range(b):
            if ref_lens[i]:
                codes[i, :ref_lens[i]] = refs_all[i]
            if counts[i]:
                codes[i, ref_lens[i]:totals[i]] = frames_all[i][:counts[i]]
        wav = vocoder.decode_bucketed(self.vocoder_params, self.vocoder_config, np.swapaxes(codes, 1, 2),
                                      bucket=DECODE_BUCKET)
        spf = T.SAMPLES_PER_FRAME
        return [AudioBuffer(wav[i, int(ref_lens[i]) * spf:int(totals[i]) * spf], T.OUTPUT_SAMPLE_RATE)
                for i in range(b)]

    def _generate_batch_group(self, group: "BatchGroup") -> tuple[list[np.ndarray], np.ndarray]:
        """Run a prepared group's batched frame loop to its end (w8a8 when
        ``self.w8a8``; each dp replica's streams on that replica, the
        replicas in lock-step); returns (per-stream frames [max_new, 16],
        frame counts)."""
        self._run_batch_loops(group, group.frame_limits)
        frames = np.concatenate([g.state.frames.cpu().numpy() for g in group.shards])
        counts = np.concatenate([g.state.frame_idx.cpu().numpy() for g in group.shards])  # one read a shard
        return [frames[j] for j in range(frames.shape[0])], counts

    def _run_batch_loops(self, group: "BatchGroup", frame_limits: list[int], until=None) -> None:
        """Advance every share of ``group`` (``BatchGroup.shards``) on its
        replica, the replicas in lock-step, until each stream is done or at
        its limit in ``frame_limits`` (one a stream of the whole group), or
        until ``until`` returns True (``core.generate_frames_replicas``)."""
        with quant.w8a8_scope(self.w8a8):
            core.generate_frames_replicas(self.config.talker, self.config.code_predictor, group.scfg,
                                          self._replica_loops(group, frame_limits), self.mesh, until)

    def _replica_loops(self, group: "BatchGroup", frame_limits: list[int]) -> list[core.ReplicaLoop]:
        """Each share of ``group`` as the driver takes it: its replica's
        trees, its state and inputs, its streams' slice of ``frame_limits``."""
        shares, at = [], 0
        for g in group.shards:
            tree, cp_tree = self._replica_trees(g.replica)
            shares.append(core.ReplicaLoop(tree, cp_tree, g.state, g.trailing, g.trailing_lens, g.pad_embed,
                                           g.uniforms, frame_limits[at:at + g.batch]))
            at += g.batch
        return shares

    def _replica_trees(self, r: int) -> tuple:
        """(talker, code predictor) of dp replica r: the model's own for 0."""
        if r == 0:
            return self.talker_params, self.cp_params
        return self.replicas[r].talker_params, self.replicas[r].cp_params

    def _split_batch(self, b: int, cache: nn.KVCache) -> list[tuple[int, range, nn.KVCache | nn.TPCache]]:
        """How a batch of ``b`` streams, prepared with one padding, runs: a list
        of (replica, its streams, its cache). Unsharded: all on the model's
        device. Under a mesh with dp > 1 and ``b`` a multiple of dp: the
        streams split evenly over the replicas in order, the cache by
        ``sharding.batch_cache_spec`` (streams on dp, KV heads on tp); when
        ``b`` is not a multiple, the JAX package's warning, and every stream
        on replica 0."""
        if self.mesh is None:
            return [(0, range(b), cache)]
        dp = self.mesh.shape["dp"]
        if dp == 1 or b % dp:
            if dp > 1:
                logger.warning("synthesize_batch: batch %d not divisible by dp=%d; running without dp sharding.",
                               b, dp)
            return [(0, range(b), self._place_cache(cache))]
        per = b // dp
        parts = _split_cache(cache, sharding.batch_cache_spec(), self.mesh)
        return [(r, range(r * per, (r + 1) * per), parts[r]) for r in range(dp)]

    @torch.no_grad()
    def _prepare_batch_group(
        self,
        kind: str,
        texts: list[str],
        voices: list,
        languages: list[str],
        instructs: list[str | None],
        options: SynthesisOptions,
        seeds: list[int],
    ) -> "BatchGroup":
        """Encode and prefill one layout group of a batch (``synthesize_batch``
        and ``synthesize_streaming_batch`` share it). ICL streams cap their
        frames at max(``ICL_MIN_FRAMES``, ``ICL_FRAMES_PER_TOKEN`` x text
        tokens) and take a repetition penalty of at least
        ``ICL_MIN_REPETITION_PENALTY``; other layouts share
        ``options.max_length``. The group's KV cache holds its prompt bucket
        + the frames' bucket + 8 rows for every stream (no growth tiers). A
        ``basic`` group of preset speakers only runs the CustomVoice layout;
        one with an x-vector clone runs the clone layout for all its streams,
        a preset speaker's vector being its codec speaker-token embedding.
        The prefill is the layout's ``generation.batch`` function, called
        once a dp replica on its share of the padded inputs (all streams on
        the model's device when unsharded)."""
        b = len(texts)
        dev = self.device
        encoded = [self._encode_text(t) for t in texts]
        refs: list[np.ndarray | None] = [None] * b
        if kind == "icl":
            per_max = [min(options.max_length, max(ICL_MIN_FRAMES, len(e) * ICL_FRAMES_PER_TOKEN)) for e in encoded]
            scfg = replace(options, repetition_penalty=max(options.repetition_penalty,
                                                           ICL_MIN_REPETITION_PENALTY)).sampling_config()
        else:
            per_max = [options.max_length] * b
            scfg = options.sampling_config()
        max_new_bucket = next_bucket(max(per_max), buckets=FRAME_BUCKETS)
        uniforms = torch.from_numpy(np.stack([rng.pcg_uniform_sequence(s, max_new_bucket + 1) for s in seeds])).to(dev)
        lang_ids = [T.language_token_id(lang) for lang in languages]
        stack = self.config.talker.layer_stack()

        def new_caches(prefill_rows: int) -> nn.KVCache:
            return nn.init_kv_cache(stack, b, prefill_rows + max_new_bucket + 8, self.compute_dtype, dev)

        def padded(seqs: list[list[int]]) -> tuple[torch.Tensor, list[int]]:
            arr = np.zeros((b, next_bucket(max(max(len(q) for q in seqs), 1), TEXT_BUCKET)), np.int64)
            for i, q in enumerate(seqs):
                arr[i, :len(q)] = q
            return torch.from_numpy(arr).to(dev), [len(q) for q in seqs]

        def speaker_vecs() -> torch.Tensor:
            return torch.stack([
                torch.as_tensor(np.asarray(v.speaker_embedding), device=dev).to(self.compute_dtype)
                if isinstance(v, VoiceClonePrompt)
                else talker.embed_codec(self.talker_params, torch.tensor(T.speaker_info(v).token_id, device=dev))
                for v in voices
            ])

        if kind == "icl":
            all_text_ids, n_texts = padded([list(v.ref_text_ids) + list(e) + [T.TTS_EOS]
                                            for v, e in zip(voices, encoded)])
            refs = [np.asarray(v.ref_codes, np.int32) for v in voices]
            cb = next_bucket(max(r.shape[0] for r in refs) + 1, TEXT_BUCKET)
            bos = talker.embed_codec(self.talker_params, torch.tensor([T.CODEC_BOS], device=dev))
            codec_rows = bos.new_zeros((b, cb, bos.shape[-1]))
            for i, r in enumerate(refs):
                codec_rows[i, :1] = bos
                codec_rows[i, 1:r.shape[0] + 1] = self._sum_ref_codec_embeddings(r)
            inputs = (all_text_ids, n_texts, speaker_vecs(), codec_rows, [r.shape[0] + 1 for r in refs], lang_ids)
            run, kw = gbatch.prefill_voice_clone_icl_batch, {"sequential": options.icl_sequential}
            prefill_rows = 9 + cb + (all_text_ids.shape[1] if options.icl_sequential else 0)
        else:
            text_ids, text_lens = padded(encoded)
            prefill_rows, kw = CUSTOM_VOICE_PROMPT_LEN, {}
            if kind == "design":
                instruct_ids, instruct_lens = padded(
                    [self._encode_text(f"<|im_start|>user\n{ins}<|im_end|>\n") for ins in instructs])
                inputs = (text_ids, text_lens, instruct_ids, instruct_lens, lang_ids)
                run, prefill_rows = gbatch.prefill_voice_design_batch, instruct_ids.shape[1] + 9
            elif any(isinstance(v, VoiceClonePrompt) for v in voices):
                inputs, run = (text_ids, text_lens, speaker_vecs(), lang_ids), gbatch.prefill_voice_clone_batch
            else:
                inputs = (text_ids, text_lens, [T.speaker_info(v).token_id for v in voices], lang_ids)
                run = gbatch.prefill_custom_voice_batch
        shards = []
        for r, idx, cache in self._split_batch(b, new_caches(prefill_rows)):
            tree, _ = self._replica_trees(r)
            rdev = tree["norm"].device
            part = [x[idx.start:idx.stop].to(rdev) if isinstance(x, torch.Tensor) else x[idx.start:idx.stop]
                    for x in (*inputs, uniforms)]
            state, trailing, trailing_lens, pad = run(tree, self.config.talker, scfg, *part[:-1], cache, part[-1],
                                                      max_new_bucket, mesh=self.mesh, w8a8=self.w8a8, **kw)
            shards.append(BatchGroup(state, scfg, trailing, trailing_lens, pad, part[-1],
                                     [per_max[i] for i in idx], [refs[i] for i in idx], r))
        if len(shards) == 1:
            return shards[0]
        return BatchGroup(None, scfg, None, [], None, uniforms, per_max, refs, parts=shards)

    def synthesize_streaming_batch(
        self,
        texts: list[str],
        speakers: list | str = "ryan",
        languages: list[str] | str = "english",
        options: SynthesisOptions | None = None,
        seeds: list[int] | None = None,
        instructs: list[str | None] | None = None,
    ) -> "StreamingBatchSession":
        """Batched streaming: B streams advanced together a chunk at a time
        (``StreamingBatchSession.next_chunks``), each chunk's new frames of
        all streams decoded in one pass of the sample-exact streaming
        vocoder. Each stream's chunks put together are its
        ``synthesize_batch`` audio (up to matmul-tiling ulps). Arguments as
        ``synthesize_batch``'s, but one session runs one prompt layout
        (preset speakers and x-vector clones mix; ICL clones and designs each
        need a session of their own); another mix raises. An ICL stream's
        reference codes go through the streaming vocoder ahead of its
        frames, so its first chunks may be empty."""
        options, speakers, languages, instructs, seeds = self._batch_args(
            texts, speakers, languages, options, seeds, instructs)
        groups = self._split_batch_groups(speakers, instructs)
        if len(groups) > 1:
            raise ValueError(
                "synthesize_streaming_batch runs one prompt layout per session; got "
                f"{[k for k, _ in groups]}. Split the request by layout (preset speakers and x-vector clones may mix)."
            )
        group = self._prepare_batch_group(groups[0][0], texts, speakers, languages, instructs, options, seeds)
        return StreamingBatchSession(self, group, options)

    # ------------------------------------------------------------------
    # Decode helpers
    # ------------------------------------------------------------------

    def codes_to_tensor(self, frames: np.ndarray) -> np.ndarray:
        """[T, 16] frame-major codes -> [1, 16, T] codebook-major."""
        return np.asarray(frames, np.int32).T[None]

    def _decode_behind(self, prefix: np.ndarray | None, frames: np.ndarray) -> AudioBuffer:
        """Decode ``frames``; behind a reference ``prefix`` (ICL), decode
        [prefix || frames] in one bucketed call and cut the prefix's share
        of the samples (proportional to its frames) from the front."""
        if prefix is None:
            return self.decode_codes(frames)
        combined = np.concatenate([prefix, frames], axis=0)
        audio = self.decode_codes(combined)
        cut = len(prefix) * len(audio) // max(len(combined), 1)
        return AudioBuffer(audio.samples[min(cut, len(audio)):], audio.sample_rate)

    def decode_codes(self, frames: np.ndarray) -> AudioBuffer:
        """Decode [T, 16] frames to 24 kHz audio (bucketed, exact)."""
        frames = np.asarray(frames, np.int32)
        if frames.size == 0:
            return AudioBuffer(np.zeros(0, np.float32), T.OUTPUT_SAMPLE_RATE)
        wav = vocoder.decode_bucketed(
            self.vocoder_params, self.vocoder_config, self.codes_to_tensor(frames), bucket=DECODE_BUCKET
        )
        return AudioBuffer(wav[0], T.OUTPUT_SAMPLE_RATE)


def prefix_piece_sizes(n: int, chunk: int) -> list[int]:
    """The pieces in which ``StreamingSession._feed_prefix`` feeds n
    reference frames: ``chunk`` frames while they last, then a binary split
    of the remainder, smallest first."""
    r = n % chunk
    return [chunk] * (n // chunk) + [1 << b for b in range(r.bit_length()) if r >> b & 1]


def _pad_rows(t: torch.Tensor, delta: int) -> torch.Tensor:
    """``t`` [L, B, S, ...] with ``delta`` zero rows appended along S."""
    return torch.cat([t, t.new_zeros(t.shape[:2] + (delta,) + t.shape[3:])], dim=2)


def _grown_cache(cache: nn.KVCache | nn.TPCache, delta: int) -> nn.KVCache | nn.TPCache:
    """``cache`` with ``delta`` zero rows, every rank's part of a split one."""
    if isinstance(cache, nn.TPCache):
        return nn.TPCache(tuple(_grown_cache(part, delta) for part in cache.parts))
    return nn.KVCache(_pad_rows(cache.k, delta), _pad_rows(cache.v, delta))


def _split_cache(cache: nn.KVCache, spec: sharding.P, mesh: sharding.Mesh) -> list[nn.TPCache]:
    """Every replica's ranks' parts of ``cache`` by ``spec``."""
    k, v = sharding.shard_leaf(cache.k, spec, mesh), sharding.shard_leaf(cache.v, spec, mesh)
    return [nn.TPCache(tuple(nn.KVCache(a, b) for a, b in zip(kr, vr))) for kr, vr in zip(k, v)]


class Replica(NamedTuple):
    """One dp replica of a sharded model: its tp ranks' talker, its whole
    code predictor and its first device."""

    talker_params: sharding.ShardedTree
    cp_params: dict
    device: torch.device


@dataclass
class BatchGroup:
    """One prompt-layout group of a batch, prefilled: the batched loop's
    state and inputs, each stream's frame budget, and each stream's ICL
    reference codes (None outside ICL); under a mesh, split over the dp
    replicas (``parts``)."""

    state: core.BatchGenState | None
    scfg: sampling.SamplingConfig
    trailing: torch.Tensor | None  # [B, Tb, hidden]
    trailing_lens: list[int]
    pad_embed: torch.Tensor | None  # [hidden]
    uniforms: torch.Tensor  # [B, max_new + 1]
    frame_limits: list[int]
    refs: list[np.ndarray | None]
    replica: int = 0  # the dp replica whose devices hold the state
    # Under a dp split: each replica's share of the streams, in stream order,
    # each a group of its own (this group then holds no loop state itself).
    parts: list["BatchGroup"] | None = None

    @property
    def shards(self) -> list["BatchGroup"]:
        """The groups whose loops run: the dp parts, or this group."""
        return self.parts or [self]

    @property
    def batch(self) -> int:
        return len(self.frame_limits)

    @property
    def max_new(self) -> int:
        """The frames buffer's rows."""
        return self.shards[0].state.frames.shape[1]


class _HostCopy:
    """Device tensors on their way to the host behind the work queued so
    far. On a card each is copied without blocking into pinned memory and
    an event is recorded after the copies, so that ``wait`` waits for that
    work only: a plain ``.cpu()`` of chunk k after chunk k+1 is queued would
    wait for chunk k+1 too. On the CPU, clones (the loop goes on updating
    its state in place)."""

    def __init__(self, *tensors: torch.Tensor):
        self.events = []
        host = []
        for t in tensors:
            if t.device.type == "cuda":
                host.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True))
            else:
                host.append(t.clone())
        for dev in {t.device for t in tensors if t.device.type == "cuda"}:
            with torch.cuda.device(dev):
                self.events.append(torch.cuda.Event())
                self.events[-1].record()
        self.host = tuple(host)

    def wait(self) -> tuple:
        for event in self.events:
            event.synchronize()
        return self.host


class _Landed:
    """The ``until`` of a chunk queued ahead (``core.generate_frames``):
    True once the chunk before it, the one the host reads next, is on the
    host (its ``_HostCopy``'s events have completed: a query, no wait). The
    host then stops launching the queued chunk's frames and reads, so a
    chunk queued ahead never delays the one before it. ``cut`` records that
    it returned True: the queued chunk may then lack frames, and is resumed
    before its decode is queued."""

    def __init__(self, fetch: _HostCopy):
        self.fetch, self.cut = fetch, False

    def __call__(self) -> bool:
        self.cut = self.cut or all(event.query() for event in self.fetch.events)
        return self.cut


def _landed(fetch: _HostCopy) -> _Landed | None:
    """The ``until`` of a chunk queued behind ``fetch``; None on the CPU,
    where ``fetch`` was taken at once and nothing runs behind the host (the
    chunk ahead is queued whole)."""
    return _Landed(fetch) if fetch.events else None


def _status(frame_idx: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """[2, ...] int64: the frame counts over the done flags, so that one
    host read takes both."""
    return torch.stack([frame_idx, done.to(torch.int64)])


class StreamingSession:
    """Pull-based streaming synthesis; also drives non-streaming synthesis.

    Holds the frame loop's state between chunks: each ``next_chunk``
    advances the loop by a chunk of frames and decodes only the new frames.
    The frames buffer and the talker cache start at ``GROWTH_INITIAL_FRAMES``
    frames and grow one ``FRAME_BUCKETS`` tier at a time (the streaming
    vocoder's KV cache with them); the uniform stream covers the whole
    requested length, so growth never changes a token. An ICL clone's
    reference codes (``prefix_codes``) are vocoder context: the streaming
    vocoder takes them ahead of the first chunk (``_feed_prefix``), the
    chunk-local modes decode them in front of the frames, and their
    samples are never emitted.

    The host reads the device once a chunk (its samples, frame count and
    done flag, copied behind it: ``_HostCopy``), or once a segment of
    ``run_to_completion``. With ``options.streaming_lookahead`` k,
    ``next_chunk`` queues up to k more chunks while the card makes the one
    it returns (``_pending``, up to ``_spec_frontier``), and stops launching
    their frames as soon as that one is on the host (``_Landed``), so the
    queue never delays it; a chunk cut short is carried on first at the next
    call. A chunk queued past EOS runs frozen frames and its samples are
    dropped.
    """

    def __init__(self, model: Qwen3TTS, state: core.GenState, scfg: sampling.SamplingConfig,
                 options: SynthesisOptions, trailing: torch.Tensor, trailing_len: int, pad_embed: torch.Tensor,
                 uniforms: torch.Tensor, request: int | None = None):
        self.model = model
        # The id every span of this session carries (``profiling.annotate``).
        self.request = request
        self.state = state
        self.scfg = scfg
        self.options = options
        self.trailing = trailing
        self.trailing_len = trailing_len
        self.pad_embed = pad_embed
        self.uniforms = uniforms
        self.frames_emitted = 0
        self._exhausted = False
        # ICL voice cloning's reference codes [Tr, 16], decoded as vocoder
        # context ahead of the first chunk and cut from the output.
        self.prefix_codes: np.ndarray | None = None
        # The sample-exact streaming vocoder's carry (options.streaming_exact).
        self.vstate: vocoder.VocoderStreamState | None = None
        # Called once a frame by the frame loop (``core.generate_frames``'s
        # ``on_frame``); ``generation.debug.debug_generate`` sets it.
        self.on_frame = None
        # Chunks queued ahead (options.streaming_lookahead): [start frame,
        # chunk size, frame target, _HostCopy of (samples, status) or None
        # while ``_Landed`` has cut its loop short].
        self._pending: list[list] = []
        # Dispatch frontier in frames (>= frames_emitted while speculating).
        self._spec_frontier = 0

    @property
    def frames_generated(self) -> int:
        return int(self.state.frame_idx)

    def _status(self) -> tuple[int, bool]:
        """(frames made, done): one host read, which waits for the loop."""
        with profiling.annotate("q3.wait"):
            n, done = _status(self.state.frame_idx, self.state.done).tolist()
        return n, bool(done)

    def _fetch(self, wav: torch.Tensor) -> _HostCopy:
        """A chunk's samples [chunk * 1920], frame count and done flag, on
        their way to the host."""
        return _HostCopy(wav[0], _status(self.state.frame_idx, self.state.done))

    @staticmethod
    def _read(fetch: _HostCopy) -> tuple[np.ndarray, int, bool]:
        """A chunk's (samples, frames made, done) on the host."""
        with profiling.annotate("q3.wait"):
            wav, status = fetch.wait()
            n, done = status.tolist()
            return wav.numpy(), n, bool(done)

    def is_done(self) -> bool:
        return self._exhausted

    @torch.no_grad()
    def _advance(self, frame_limit: int, until=None) -> None:
        m = self.model
        self.state = core.generate_frames(
            m.talker_params, m.cp_params, m.config.talker, m.config.code_predictor, self.scfg, self.state,
            self.trailing, self.trailing_len, self.pad_embed, self.uniforms, frame_limit,
            m.cp_frame_pack, m.talker_step_pack, m.cp_step_pack, self.on_frame, m.mesh, m.tp_step_packs, until,
        )

    @torch.no_grad()
    def _advance_and_decode_chunk(self, frame_limit: int, emitted: int, chunk: int):
        """One chunk of a stream with chunk-local vocoder context: advance the
        frame loop to ``frame_limit``, then decode the ``chunk`` frame rows from
        ``emitted`` (the start clamped so that the rows lie in the buffer, as
        the JAX package's dynamic slice clamps it). Rows past the frames made are
        zeros and the vocoder is causal, so trimming the samples to the true
        frame count is exact. The buffers grow first to hold ``frame_limit``
        frames. Returns the ``_HostCopy`` of (samples, frames made, done),
        queued behind the decode."""
        self._grow_for(frame_limit)
        self._advance(frame_limit)
        s, m = self.state, self.model
        start = max(min(emitted, s.frames.shape[0] - chunk), 0)
        rows = s.frames[start:start + chunk]  # [chunk, 16]
        return self._fetch(vocoder.decode(m.vocoder_params, m.vocoder_config, rows.T[None]))

    @torch.no_grad()
    def _advance_and_decode_chunk_exact(self, frame_limit: int, emitted: int, chunk: int,
                                        until: _Landed | None = None) -> _HostCopy | None:
        """One chunk of a stream on the sample-exact streaming vocoder: advance
        the frame loop to ``frame_limit``, then decode the ``chunk`` frame rows
        from ``emitted`` carrying ``self.vstate``. The frames buffer is padded
        with ``chunk`` zero rows so that the last, partial chunk's slice is
        whole. The buffers grow first to hold ``frame_limit`` frames, so the
        decode follows the whole chunk (a second decode would feed the
        stateful vocoder twice). Returns the ``_HostCopy`` of (samples, frames
        made, done), queued behind the decode and before any later chunk; or
        None when ``until`` cut the loop short: a second call carries it on."""
        self._grow_for(frame_limit)
        self._start_vstate(chunk)
        self._advance(frame_limit, until)
        if until is not None and until.cut:
            return None
        s, m = self.state, self.model
        frames_ext = torch.cat([s.frames, s.frames.new_zeros((chunk, s.frames.shape[1]))])
        rows = frames_ext[emitted:emitted + chunk]  # [chunk, 16]
        wav, self.vstate = vocoder.decode_stream_chunk(m.vocoder_params, m.vocoder_config, self.vstate, rows.T[None])
        return self._fetch(wav)

    def _next_cap(self) -> int:
        """The frame capacity one tier up, at most the requested length's bucket."""
        cap = self.state.frames.shape[0]
        return min(next_bucket(cap + 1, buckets=FRAME_BUCKETS),
                   next_bucket(self.options.max_length, buckets=FRAME_BUCKETS))

    def _grow(self, new_cap: int) -> None:
        """Extend the frames buffer, the talker cache (every rank's, under a
        mesh) and the streaming vocoder's KV cache to ``new_cap`` frames (zero
        rows: rows past the loop's position are masked, so nothing computed
        changes)."""
        with profiling.annotate("q3.grow"):
            s = self.state
            delta = new_cap - s.frames.shape[0]
            s.frames = torch.cat([s.frames, s.frames.new_zeros((delta, s.frames.shape[1]))])
            s.cache = _grown_cache(s.cache, delta)
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

    def _prefix(self) -> np.ndarray | None:
        """The reference codes, if there are any."""
        if self.prefix_codes is None or not len(self.prefix_codes):
            return None
        return np.asarray(self.prefix_codes, np.int32)

    def _ensure_vstate(self, prefix_frames: int = 0) -> None:
        """A streaming vocoder state for the frames buffer, with
        ``next_bucket(prefix_frames, DECODE_BUCKET)`` more KV rows for a
        reference prefix."""
        if self.vstate is None:
            max_t = self.state.frames.shape[0]
            if prefix_frames:
                max_t += next_bucket(prefix_frames, DECODE_BUCKET)
            self.vstate = vocoder.init_stream_state(self.model.vocoder_config, max_t, device=self.model.device)

    def _start_vstate(self, chunk: int) -> None:
        """Before the first chunk on the streaming vocoder: its state, with
        the reference prefix (if any) fed in pieces of at most ``chunk``."""
        if self.vstate is None:
            prefix = self._prefix()
            self._ensure_vstate(0 if prefix is None else len(prefix))
            if prefix is not None:
                self._feed_prefix(prefix, chunk)

    @torch.no_grad()
    def _feed_prefix(self, prefix: np.ndarray, chunk: int) -> None:
        """Advance the streaming vocoder through the ICL reference codes
        without emitting audio: the sample-exact form of decoding [reference
        || frames] and cutting the reference's samples. The pieces are
        ``chunk`` frames, then a binary split of the remainder (the JAX
        package's pieces, so that each shape compiles once there: see
        ``prefix_piece_sizes``)."""
        m, at = self.model, 0
        sizes = prefix_piece_sizes(len(prefix), chunk)
        with profiling.annotate("q3.prefix", self.request) as span:
            span.set("pieces", len(sizes))
            span.set("frames", len(prefix))
            codes = torch.from_numpy(prefix).to(m.device)
            for size in sizes:
                with profiling.annotate("q3.piece") as piece:
                    piece.set("frames", size)
                    _, self.vstate = vocoder.decode_stream_chunk(m.vocoder_params, m.vocoder_config, self.vstate,
                                                                 codes[at:at + size].T[None])
                at += size

    def _advance_managed(self, target: int) -> tuple[int, bool]:
        """Advance to ``target`` total frames, growing the buffers a tier at a
        time only when the loop stops at a full one (a session that meets EOS
        early never holds the requested length's buffers). One host read a
        segment. Returns (frames made, done)."""
        target = min(target, self.options.max_length)
        while True:
            self._advance(target)
            n, done = self._status()
            if done or n >= target:
                return n, done
            self._grow_for(n + 1)  # stopped at a full buffer: one tier up

    def run_to_completion(self) -> np.ndarray:
        """Generate every remaining frame; returns [n, 16] int32."""
        with profiling.annotate("q3.audio", self.request):
            n, _ = self._advance_managed(self.options.max_length)
            with profiling.annotate("q3.wait"):
                frames = self.state.frames[:n].cpu().numpy()
            self.frames_emitted = n
            self._exhausted = True
            return frames

    def run_to_audio(self) -> AudioBuffer:
        """Non-streaming synthesis as chunks of ``DECODE_BUCKET`` frames on
        the sample-exact streaming vocoder (an ICL prefix fed first, in
        pieces of up to ``DECODE_BUCKET``): the audio of
        ``decode_codes(frames)`` up to matmul-tiling ulps. Each chunk is
        queued before the previous one is read, so one chunk stays in flight
        ahead of the read frontier; a chunk queued past EOS runs frozen
        frames and is dropped. Chunks that ``next_chunk`` queued ahead come
        first. With ``streaming_exact=False``, or once the session is
        exhausted: every frame, then one bucketed decode (with a prefix: of
        [prefix || frames], the prefix's share of the samples cut from the
        front)."""
        with profiling.annotate("q3.audio", self.request):
            if not self.options.streaming_exact or self._exhausted:
                frames = self.run_to_completion()
                return self.model._decode_behind(self._prefix() if len(frames) else None, frames)
            chunk, max_len = DECODE_BUCKET, self.options.max_length
            parts: list[np.ndarray] = []
            total: int | None = None  # the true frame count once EOS or the limit is seen

            def take(e0: int, size: int, target: int, fetch: _HostCopy | None) -> None:
                nonlocal total
                if total is not None and e0 >= total:
                    return  # queued past EOS: dropped
                if fetch is None:  # queued ahead and cut short: the rest of its frames, then its decode
                    fetch = self._advance_and_decode_chunk_exact(target, e0, size)
                wav, n, done = self._read(fetch)
                emitted_here = min(n, e0 + size) - e0
                if emitted_here > 0:
                    parts.append(wav[:emitted_here * T.SAMPLES_PER_FRAME])
                if done or n >= max_len:
                    total = n if total is None else min(total, n)

            # Chunks queued by next_chunk were never returned, and the stateful
            # vocoder has consumed them: their audio heads this output.
            spec = self._spec_frontier if self._pending else self.frames_emitted
            for queued in self._pending:
                take(*queued)
            self._pending.clear()
            inflight: list[tuple] = []
            while spec < max_len and total is None:
                target = min(spec + chunk, max_len)
                inflight.append((spec, chunk, target, self._advance_and_decode_chunk_exact(target, spec, chunk)))
                spec = target
                while len(inflight) > 1:
                    take(*inflight.pop(0))
            for queued in inflight:
                take(*queued)
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
        with profiling.annotate("q3.chunk", self.request):
            chunk = max(self.options.chunk_frames, 1)
            if self.frames_emitted == 0 and self.options.first_chunk_frames:
                chunk = max(min(self.options.first_chunk_frames, chunk), 1)
            if self.options.streaming_exact:
                return self._next_chunk_exact(chunk)
            return self._next_chunk_legacy(chunk)

    def _queue_exact(self, chunk: int, until: _Landed | None = None) -> None:
        """Queue one chunk at the dispatch frontier: its frames, its decode
        and the copy of its results; with ``until``, as far as it lets the
        host go."""
        e0, target = self._spec_frontier, min(self._spec_frontier + chunk, self.options.max_length)
        self._pending.append([e0, chunk, target, self._advance_and_decode_chunk_exact(target, e0, chunk, until)])
        self._spec_frontier = target

    def _resume_last(self, until: _Landed | None = None) -> None:
        """Carry the last queued chunk on where ``_Landed`` cut it short (the
        loop is sequential: nothing is queued behind it until it is whole)."""
        e0, size, target, _ = self._pending[-1]
        self._pending[-1][3] = self._advance_and_decode_chunk_exact(target, e0, size, until)

    def _next_chunk_exact(self, chunk: int) -> AudioBuffer | None:
        if not self._pending:
            self._queue_exact(chunk)
        elif self._pending[0][3] is None:
            self._resume_last()
        # Queue up to streaming_lookahead further chunks while the card makes
        # this one, and stop launching once it is on the host: the card then
        # runs chunk k+1's frames while the host hands chunk k back.
        until = _landed(self._pending[0][3])
        steady = max(self.options.chunk_frames, 1)
        while until is None or not until.cut:
            if self._pending[-1][3] is None:
                self._resume_last(until)
            elif (len(self._pending) <= max(self.options.streaming_lookahead, 0)
                  and self._spec_frontier < self.options.max_length):
                self._queue_exact(steady, until)
            else:
                break
        e0, size, _, fetch = self._pending.pop(0)
        wav, n, done = self._read(fetch)
        done = done or n >= self.options.max_length
        if n <= e0:
            self._exhausted = True
            self._pending.clear()
            return None
        # The chunk ran with frame_limit e0 + size, so n <= e0 + size.
        self.frames_emitted = n
        if done:
            self._exhausted = True
            self._pending.clear()
        # Rows past n were zero-code frames: decoded, their samples dropped.
        return AudioBuffer(wav[:(n - e0) * T.SAMPLES_PER_FRAME], T.OUTPUT_SAMPLE_RATE)

    def _next_chunk_legacy(self, chunk: int) -> AudioBuffer | None:
        target = min(self.frames_emitted + chunk, self.options.max_length)
        prefix = self._prefix() if self.frames_emitted == 0 else None
        if prefix is not None:
            return self._first_chunk_legacy_prefixed(prefix, target, chunk)
        wav, n, done = self._read(self._advance_and_decode_chunk(target, self.frames_emitted, chunk))
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
            with profiling.annotate("q3.wait"):
                new = self.state.frames[emitted_before:n].cpu().numpy()
            wavb = vocoder.decode_bucketed(self.model.vocoder_params, self.model.vocoder_config,
                                           self.model.codes_to_tensor(new), bucket=chunk)
            return AudioBuffer(wavb[0], T.OUTPUT_SAMPLE_RATE)
        return AudioBuffer(wav[:(n - emitted_before) * T.SAMPLES_PER_FRAME], T.OUTPUT_SAMPLE_RATE)

    @torch.no_grad()
    def _first_chunk_legacy_prefixed(self, prefix: np.ndarray, target: int, chunk: int) -> AudioBuffer | None:
        """The first chunk of a chunk-local stream of an ICL clone: decode
        [reference || the chunk's frames] and emit only the chunk's samples
        (the vocoder is causal, 1920 samples a frame)."""
        self._grow_for(target)
        self._advance(target)
        n, done = self._status()
        done = done or n >= self.options.max_length
        if n == 0:
            self._exhausted = True
            return None
        self.frames_emitted = n
        if done:
            self._exhausted = True
        with profiling.annotate("q3.wait"):
            new = self.state.frames[:n].cpu().numpy()
        m = self.model
        wav = vocoder.decode_bucketed(m.vocoder_params, m.vocoder_config,
                                      m.codes_to_tensor(np.concatenate([prefix, new])), bucket=chunk)
        return AudioBuffer(wav[0][len(prefix) * T.SAMPLES_PER_FRAME:], T.OUTPUT_SAMPLE_RATE)

    def __iter__(self):
        return self

    def __next__(self) -> AudioBuffer:
        chunk = self.next_chunk()
        if chunk is None:
            raise StopIteration
        return chunk


class StreamingBatchSession:
    """Pull-based streaming for a batch of utterances of one prompt layout.

    ``next_chunks()`` returns ``[AudioBuffer | None] * B``: each live
    stream's next chunk of samples, ``None`` once that stream is done (and
    ever after). All streams advance together through the batched frame
    loop (``core.generate_frames_batch``), then the batch-native
    sample-exact streaming vocoder decodes the chunk's rows of every stream
    in one pass, so each stream's chunks put together are its
    ``synthesize_batch`` audio. The first chunk holds ``first_chunk_frames``
    frames, then ``chunk_frames``. ICL streams run on their own combined
    timeline: vocoder grid row t of stream i is reference code t while t is
    inside its reference, then generated frame ``t - ref_len``; chunks
    inside a reference prefix are empty (its samples are never emitted).

    Buffers hold the max_length bucket from the start (no growth tiers);
    the vocoder's KV cache gets room for the longest reference and a chunk
    of headroom. ``options.streaming_lookahead`` chunks are queued ahead of
    the one returned, as in ``StreamingSession`` (``_pending``, cut short
    once that one is on the host);
    each chunk's samples, frame counts and done flags are copied to the host
    behind it and read when it is popped. Its loop runs with
    ``decode_tiering=False``, as the JAX package's batched session forces it
    (``core.generate_frames_batch`` switches it off for every batched loop).
    """

    def __init__(self, model: Qwen3TTS, group: BatchGroup, options: SynthesisOptions):
        self.model = model
        self.group = group
        self.options = options
        self.batch = group.batch
        self.frames_emitted = 0
        self._exhausted = False
        self._stream_done = [False] * self.batch
        refs = group.refs
        self._ref_lens = [0 if r is None else len(r) for r in refs]
        cmax = max(self._ref_lens)
        self.ref_codes = None
        if cmax > 0:
            arr = np.zeros((self.batch, cmax, T.NUM_CODE_GROUPS), np.int32)
            for i, r in enumerate(refs):
                if r is not None:
                    arr[i, :len(r)] = r
            self.ref_codes = torch.from_numpy(arr).to(model.device)
            self._ref_lens_dev = core.to_device(self._ref_lens, model.device)
        # The grid's end: every stream's reference prefix and its own budget.
        self._grid_max = max(n + m for n, m in zip(self._ref_lens, group.frame_limits))
        headroom = max(options.chunk_frames, options.first_chunk_frames or 1, 1)
        self.vstate = vocoder.init_stream_state(model.vocoder_config, group.max_new + cmax + headroom,
                                                batch=self.batch, device=model.device)
        # Chunks queued ahead: [start grid row, chunk size, grid target,
        # _HostCopy of (samples [B, chunk * 1920], status [2, B]) or None
        # while ``_Landed`` has cut its loops short].
        self._pending: list[list] = []
        self._spec_frontier = 0

    def is_done(self) -> bool:
        return self._exhausted

    @torch.no_grad()
    def _advance_and_decode_chunk_batch(self, target: int, emitted: int, chunk: int,
                                        until: _Landed | None = None) -> _HostCopy | None:
        """Advance every live stream to at most ``target`` frames (each within
        its own budget), then decode grid rows ``emitted .. emitted + chunk``
        of all streams on the streaming vocoder. Rows past a stream's frames
        are zero codes (the stack is causal: trimming is exact). Returns the
        ``_HostCopy`` of (samples [B, chunk * 1920], status [2, B]: frames
        made and done, a stream), queued behind the decode; or None when
        ``until`` cut the loops short: a second call carries them on."""
        m, g = self.model, self.group
        m._run_batch_loops(g, [min(limit, target) for limit in g.frame_limits], until)
        if until is not None and until.cut:
            return None
        frames = torch.cat([p.state.frames.to(m.device) for p in g.shards])
        b, _, n_codes = frames.shape
        frames_ext = torch.cat([frames, frames.new_zeros((b, chunk, n_codes))], dim=1)
        if self.ref_codes is None:
            start = min(emitted, frames_ext.shape[1] - chunk)
            rows = frames_ext[:, start:start + chunk]  # [B, chunk, 16]
        else:
            # The grid gather: each stream's reference prefix, then its frames.
            dev = frames_ext.device
            t_idx = emitted + torch.arange(chunk, device=dev)
            ref_lens = self._ref_lens_dev
            gen_idx = (t_idx[None, :] - ref_lens[:, None]).clamp(0, frames_ext.shape[1] - 1)  # [B, chunk]
            gen_rows = torch.gather(frames_ext, 1, gen_idx[..., None].expand(-1, -1, n_codes))
            ref_rows = self.ref_codes[:, t_idx.clamp(0, self.ref_codes.shape[1] - 1)]
            rows = torch.where((t_idx[None, :] < ref_lens[:, None])[..., None], ref_rows, gen_rows)
        wav, self.vstate = vocoder.decode_stream_chunk(m.vocoder_params, m.vocoder_config, self.vstate,
                                                       rows.transpose(1, 2))
        status = torch.cat([_status(p.state.frame_idx, p.state.done).to(m.device) for p in g.shards], dim=1)
        return _HostCopy(wav, status)

    def _dispatch_ahead(self, chunk: int, until: _Landed | None = None) -> None:
        """Queue one chunk of every stream at the dispatch frontier; with
        ``until``, as far as it lets the host go."""
        e0, target = self._spec_frontier, min(self._spec_frontier + chunk, self._grid_max)
        self._pending.append([e0, chunk, target, self._advance_and_decode_chunk_batch(target, e0, chunk, until)])
        self._spec_frontier = target

    def _resume_last(self, until: _Landed | None = None) -> None:
        """Carry the last queued chunk on where ``_Landed`` cut it short."""
        e0, chunk, target, _ = self._pending[-1]
        self._pending[-1][3] = self._advance_and_decode_chunk_batch(target, e0, chunk, until)

    def next_chunks(self) -> list[AudioBuffer | None] | None:
        """Advance all live streams one chunk; None when every stream is done."""
        if self._exhausted:
            return None
        chunk = max(self.options.chunk_frames, 1)
        if self.frames_emitted == 0 and self.options.first_chunk_frames:
            chunk = max(min(self.options.first_chunk_frames, chunk), 1)
        if not self._pending:
            self._dispatch_ahead(chunk)
        elif self._pending[0][3] is None:
            self._resume_last()
        # As StreamingSession._next_chunk_exact: queue ahead until this chunk is on the host.
        until = _landed(self._pending[0][3])
        steady = max(self.options.chunk_frames, 1)
        while until is None or not until.cut:
            if self._pending[-1][3] is None:
                self._resume_last(until)
            elif len(self._pending) <= max(self.options.streaming_lookahead, 0) and self._spec_frontier < self._grid_max:
                self._dispatch_ahead(steady, until)
            else:
                break
        e0, chunk, _, fetch = self._pending.pop(0)
        wav, status = fetch.wait()
        wav = wav.numpy()
        ns, dones = status.tolist()
        spf = T.SAMPLES_PER_FRAME
        out: list[AudioBuffer | None] = []
        for i in range(self.batch):
            n_grid = self._ref_lens[i] + ns[i]
            if self._stream_done[i] or n_grid <= e0:
                self._stream_done[i] = True
                out.append(None)
                continue
            # The audible window: grid rows past this stream's reference prefix.
            lo, hi = max(e0, self._ref_lens[i]), min(e0 + chunk, n_grid)
            samples = wav[i, (lo - e0) * spf:(hi - e0) * spf] if hi > lo else np.zeros(0, np.float32)
            out.append(AudioBuffer(samples, T.OUTPUT_SAMPLE_RATE))
            if (dones[i] or ns[i] >= self.group.frame_limits[i]) and n_grid <= e0 + chunk:
                self._stream_done[i] = True
        self.frames_emitted = e0 + chunk
        if all(self._stream_done) or (self._spec_frontier >= self._grid_max and not self._pending):
            self._exhausted = True
            self._pending.clear()
        return out

    def __iter__(self):
        return self

    def __next__(self) -> list[AudioBuffer | None]:
        chunks = self.next_chunks()
        if chunks is None:
            raise StopIteration
        return chunks
