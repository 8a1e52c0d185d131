"""Autoregressive generation core: the frame loop.

PyTorch port of ``qwen3_tts_tpu/generation/core.py``. Per frame:
  1. embed the current semantic token,
  2. code predictor: 15 acoustic codes (argmax; the route ``cp.cp_route``
     names: on the card one kernel call, or Jacobi iterations),
  3. store frame [semantic, acoustic x15],
  4. residual-VQ fuse: semantic embed + sum(acoustic embeds) + trailing text,
  5. talker decode step -> logits,
  6. penalties (repetition, suppression, min-new-tokens) -> sample,
  7. update the penalty mask; done := (next == EOS).

The JAX loop is one ``while_loop`` with no host syncs. Here the frame index
and cache position are host integers, all tensors stay on the device, and
the loop reads ``done`` once per frame (the only device-to-host read).

``generate_frames`` re-enters: a streaming session calls it chunk by chunk
with a higher ``frame_limit``, on a frames buffer and a cache that may have
grown (new tensors) between calls; the uniform drawn for frame i does not
depend on the buffer's size.

``generate_frames_batch`` is the loop of B streams (the JAX package's
vmapped loop in its ``generation/batch.py``), each with its own cache position,
frame count and frame limit, re-entered the same way by a
``StreamingBatchSession``.

Both take the ``mesh`` of a sharded model (``Qwen3TTS.shard``): the talker
is then one replica's ``parallel.sharding.ShardedTree`` and the cache an
``nn.TPCache``; the rest of the frame stays on the replica's first device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..models import code_predictor as cp
from ..models import talker
from ..models import tokens as T
from ..models.config import CodePredictorConfig, TalkerConfig
from ..ops import nn, sampling
from ..parallel import collectives
from ..parallel.sharding import ShardedTree


@dataclass
class GenState:
    """Carried state of the frame loop (tensors updated in place)."""

    cache: nn.KVCache | nn.TPCache  # talker KV cache (split over tp ranks under a mesh)
    last_hidden: torch.Tensor  # [1, 1, hidden] normed talker hidden
    token: torch.Tensor  # [] int64 current semantic token
    penalty_mask: torch.Tensor  # [codec_vocab] float32
    frames: torch.Tensor  # [max_new, 16] int32
    frame_idx: int  # frames generated so far
    pos: int  # next talker cache write position
    done: torch.Tensor  # [] bool


def init_state(
    scfg: sampling.SamplingConfig,
    prefill_logits: torch.Tensor,
    last_hidden: torch.Tensor,
    prefill_len: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
) -> GenState:
    """Sample the first semantic token from prefill logits and seed the state."""
    vocab = prefill_logits.shape[-1]
    dev = prefill_logits.device
    penalty_mask = torch.zeros((vocab,), dtype=torch.float32, device=dev)
    suppression = sampling.build_suppression_mask(vocab, scfg.eos_token_id, dev)
    logits = sampling.apply_generation_penalties(prefill_logits, penalty_mask, suppression, scfg, 0)
    token = sampling.sample(logits, scfg, uniforms[0])[0]
    penalty_mask[token] = 1.0
    return GenState(
        cache=cache,
        last_hidden=last_hidden,
        token=token,
        penalty_mask=penalty_mask,
        frames=torch.zeros((max_new_tokens, T.NUM_CODE_GROUPS), dtype=torch.int32, device=dev),
        frame_idx=0,
        pos=prefill_len,
        done=token == scfg.eos_token_id,
    )


def generate_frames(
    talker_params: dict,
    cp_params: dict,
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    state: GenState,
    trailing: torch.Tensor,  # [Tb, hidden] per-frame text additions
    trailing_len: int,
    pad_embed: torch.Tensor,  # [hidden] tts_pad addition after trailing
    uniforms: torch.Tensor,  # [max_new + 1] float32 seeded uniform stream
    frame_limit: int,
    cp_frame_pack=None,  # the code predictor's fused_layer.CpFramePack, on the card
    talker_step_pack=None,  # the talker's fused_layer.TalkerStepPack, on the card
    cp_step_pack=None,  # the code predictor's fused_layer.CpStepPack or FusedStepPack, on the card
    on_frame=None,
    mesh=None,  # parallel.sharding.Mesh of a sharded model (talker_params one replica's ShardedTree)
    tp_step_packs=None,  # the ranks' fused_layer.tp_step_packs, on the cards
) -> GenState:
    """Advance the loop until EOS or ``frame_limit`` frames exist (at most
    the frames buffer's rows); a state already done does not move.

    ``on_frame(idx, token, codes, logits)``, when given, is called once a
    frame with the frame's index, its semantic token, its 15 acoustic codes
    and the post-penalty logits the next token is sampled from (device
    tensors; ``generation/debug.py`` reads them).

    Under a ``mesh`` the talker is a replica's ``ShardedTree`` and the cache
    an ``nn.TPCache``: decode steps run kernels 5 and 6 on every rank
    (``talker.tp_plane_mode``, the ranks' planes taken once per call) or
    the tensor-parallel layer path, never the whole-step kernel; the code
    predictor, the sampling and the step input stay on the replica's first
    device, whose kernels launch there."""
    _check_mesh(talker_params, mesh)
    suppression = sampling.build_suppression_mask(
        state.penalty_mask.shape[0], scfg.eos_token_id, state.penalty_mask.device
    )
    max_new = state.frames.shape[0]
    frame_limit = min(frame_limit, max_new)  # never run past the frames buffer
    tb = trailing.shape[0]
    # Whole-step kernel mode: take the cache's [L, S, KV*D] plane views once
    # per call (views of the same memory, written in place; a grown cache
    # is a new tensor). Under a mesh: every rank's planes, for kernels 5 + 6.
    tp_planes = talker.tp_plane_views(state.cache) if talker.tp_plane_mode(talker_params, tcfg, state.cache,
                                                                           mesh) else None
    planes = None
    if mesh is None and talker.stream_plane_mode(talker_params, tcfg, state.cache):
        planes = talker.plane_views(state.cache)
    with collectives.device_scope(state.frames.device):
        while state.frame_idx < frame_limit and not bool(state.done):
            idx = state.frame_idx
            semantic_embed = talker.embed_codec(talker_params, state.token)[None, None, :]
            codes = cp.predict_acoustic_codes(cp_params, cpcfg, state.last_hidden, semantic_embed, cp_frame_pack,
                                              cp_step_pack)
            state.frames[idx, 0] = state.token
            state.frames[idx, 1:] = codes

            acoustic_sum = cp.acoustic_embedding_sum(cp_params, codes).to(semantic_embed.dtype)
            text_add = trailing[min(idx, tb - 1)] if idx < trailing_len else pad_embed
            step_input = semantic_embed + acoustic_sum + text_add.to(semantic_embed.dtype)[None, None, :]

            if tp_planes is not None:
                hidden, logits = talker.decode_step_planes_tp(talker_params, tcfg, step_input, state.pos,
                                                              *tp_planes, tp_step_packs)
            elif planes is not None:
                hidden, logits = talker.decode_step_planes(talker_params, tcfg, step_input, state.pos, *planes,
                                                           talker_step_pack)
            else:
                hidden, logits = talker.decode_step(talker_params, tcfg, step_input, state.pos, state.cache)

            token_count = idx + 1
            logits = sampling.apply_generation_penalties(
                logits, state.penalty_mask, suppression, scfg, token_count
            )
            next_token = sampling.sample(logits, scfg, uniforms[min(token_count, max_new)])[0]
            state.penalty_mask[next_token] = 1.0
            if on_frame is not None:
                on_frame(idx, state.token, codes, logits)

            state.last_hidden = hidden
            state.token = next_token
            state.frame_idx = token_count
            state.pos += 1
            state.done = next_token == scfg.eos_token_id
    return state


def _check_mesh(talker_params, mesh) -> None:
    if (mesh is not None) != isinstance(talker_params, ShardedTree):
        raise ValueError("a sharded talker tree runs with its model's mesh, and a mesh with a sharded tree")


# ---------------------------------------------------------------------------
# Batched frame loop (throughput mode)
# ---------------------------------------------------------------------------


@dataclass
class BatchGenState:
    """The frame loop's state for B streams (the JAX package's ``GenState``
    with a leading batch axis; tensors updated in place). Each stream has
    its own cache position and frame count, kept on the host: every
    prefill length is known there."""

    cache: nn.KVCache | nn.TPCache  # [L, B, S, KV, D] (KV heads over tp ranks under a mesh)
    last_hidden: torch.Tensor  # [B, 1, hidden]
    token: torch.Tensor  # [B] int64
    penalty_mask: torch.Tensor  # [B, codec_vocab] float32
    frames: torch.Tensor  # [B, max_new, 16] int32
    frame_idx: list[int]  # frames generated so far, a stream
    pos: list[int]  # next talker cache write position, a stream
    done: torch.Tensor  # [B] bool

    @property
    def batch(self) -> int:
        return self.frames.shape[0]


def init_state_batch(
    scfg: sampling.SamplingConfig,
    prefill_logits: torch.Tensor,  # [B, vocab]
    last_hidden: torch.Tensor,  # [B, 1, hidden]
    prefill_lens: list[int],
    cache: nn.KVCache,
    uniforms: torch.Tensor,  # [B, max_new + 1]
    max_new_tokens: int,
) -> BatchGenState:
    """``init_state`` of B streams: each samples its first token with its
    own uniform ``uniforms[b, 0]``."""
    b, vocab = prefill_logits.shape
    dev = prefill_logits.device
    penalty_mask = torch.zeros((b, vocab), dtype=torch.float32, device=dev)
    suppression = sampling.build_suppression_mask(vocab, scfg.eos_token_id, dev)
    logits = sampling.apply_generation_penalties(prefill_logits, penalty_mask, suppression, scfg, 0)
    token = sampling.sample(logits, scfg, uniforms[:, 0])
    penalty_mask[torch.arange(b, device=dev), token] = 1.0
    return BatchGenState(
        cache=cache,
        last_hidden=last_hidden,
        token=token,
        penalty_mask=penalty_mask,
        frames=torch.zeros((b, max_new_tokens, T.NUM_CODE_GROUPS), dtype=torch.int32, device=dev),
        frame_idx=[0] * b,
        pos=list(prefill_lens),
        done=token == scfg.eos_token_id,
    )


def generate_frames_batch(
    talker_params: dict,
    cp_params: dict,
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    state: BatchGenState,
    trailing: torch.Tensor,  # [B, Tb, hidden]
    trailing_lens: list[int],
    pad_embed: torch.Tensor,  # [hidden]
    uniforms: torch.Tensor,  # [B, max_new + 1]
    frame_limits: list[int],  # per-stream frame budgets
    mesh=None,  # parallel.sharding.Mesh of a sharded model (talker_params one replica's ShardedTree)
) -> BatchGenState:
    """Advance B streams together until each is done or at its frame limit
    (the semantics of the JAX package's vmapped ``_generate_frames``).

    The body runs while any stream is live, for all B streams at once, on
    the layer path (``talker.decode_step_batch``,
    ``cp.predict_acoustic_codes_batch``): every projection multiplies the B
    rows with one weight read. A stream that is done or at its limit keeps
    its token, penalty mask, frames, frame count and last hidden state; its
    cache position goes on advancing (the rows it writes lie past its live
    frontier and are never read). ``done`` is read on the host once a frame.
    Tiered decode attention is off here, as in the JAX package's batched
    programs (its window is picked per stream position, on the host at
    batch 1). Under a ``mesh`` the talker is one replica's ``ShardedTree``
    (the tensor-parallel layer path) holding this state's streams, the
    code predictor that replica's, on its first device.
    """
    _check_mesh(talker_params, mesh)
    tcfg = replace(tcfg, decode_tiering=False)
    with collectives.device_scope(state.frames.device):
        b = state.batch
        dev = state.frames.device
        max_new = state.frames.shape[1]
        limits = [min(limit, max_new) for limit in frame_limits]  # never run past the frames buffer
        tb = trailing.shape[1]
        rows = torch.arange(b, device=dev)
        suppression = sampling.build_suppression_mask(state.penalty_mask.shape[1], scfg.eos_token_id, dev)
        done = state.done.tolist()
        while True:
            live = [not d and i < limit for d, i, limit in zip(done, state.frame_idx, limits)]
            if not any(live):
                return state
            idx = state.frame_idx
            # The frame's per-stream indices in one host-to-device copy.
            meta = torch.tensor(
                [state.pos, [min(i, max_new - 1) for i in idx], [min(i, tb - 1) for i in idx],
                 [int(i < n) for i, n in zip(idx, trailing_lens)], [min(i + 1, max_new) for i in idx],
                 [int(v) for v in live]], dtype=torch.int64,
            ).to(dev)
            pos, frame_row, text_row, in_text, uniform_idx, live_t = meta
            live_t = live_t.bool()

            semantic_embed = talker.embed_codec(talker_params, state.token)[:, None, :]  # [B, 1, H]
            codes = cp.predict_acoustic_codes_batch(cp_params, cpcfg, state.last_hidden, semantic_embed)  # [B, 15]
            frame = torch.cat([state.token[:, None].to(torch.int32), codes], dim=1)
            state.frames[rows, frame_row] = torch.where(live_t[:, None], frame, state.frames[rows, frame_row])

            acoustic_sum = cp.acoustic_embedding_sum(cp_params, codes).to(semantic_embed.dtype)
            text_add = torch.where(in_text.bool()[:, None], trailing[rows, text_row], pad_embed)
            step_input = semantic_embed + acoustic_sum + text_add.to(semantic_embed.dtype)[:, None, :]
            hidden, logits = talker.decode_step_batch(talker_params, tcfg, step_input, pos, state.cache)

            # Every live stream has made the same number of frames.
            token_count = min(i for i, v in zip(idx, live) if v) + 1
            logits = sampling.apply_generation_penalties(logits, state.penalty_mask, suppression, scfg, token_count)
            next_token = sampling.sample(logits, scfg, uniforms[rows, uniform_idx])
            seen = state.penalty_mask[rows, next_token]
            state.penalty_mask[rows, next_token] = torch.where(live_t, torch.ones_like(seen), seen)

            state.last_hidden = torch.where(live_t[:, None, None], hidden, state.last_hidden)
            state.token = torch.where(live_t, next_token, state.token)
            state.done = state.done | (live_t & (next_token == scfg.eos_token_id))
            state.frame_idx = [i + v for i, v in zip(idx, live)]
            state.pos = [p + 1 for p in state.pos]
            done = state.done.tolist()
