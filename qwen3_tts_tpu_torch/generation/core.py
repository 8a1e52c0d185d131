"""Autoregressive generation core: the frame loop.

PyTorch port of ``qwen3_tts_tpu/generation/core.py``. Per frame:
  1. embed the current semantic token,
  2. code predictor: 15 acoustic codes (argmax, on the card one kernel call),
  3. store frame [semantic, acoustic x15],
  4. residual-VQ fuse: semantic embed + sum(acoustic embeds) + trailing text,
  5. talker decode step -> logits,
  6. penalties (repetition, suppression, min-new-tokens) -> sample,
  7. update the penalty mask; done := (next == EOS).

The JAX loop is one ``while_loop`` with no host syncs. Here the frame index
and cache position are host integers, all tensors stay on the device, and
the loop reads ``done`` once per frame (the only device-to-host read).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import code_predictor as cp
from ..models import talker
from ..models import tokens as T
from ..models.config import CodePredictorConfig, TalkerConfig
from ..ops import nn, sampling


@dataclass
class GenState:
    """Carried state of the frame loop (tensors updated in place)."""

    cache: nn.KVCache  # talker KV cache
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
) -> GenState:
    """Advance the loop until EOS or ``frame_limit`` frames exist."""
    suppression = sampling.build_suppression_mask(
        state.penalty_mask.shape[0], scfg.eos_token_id, state.penalty_mask.device
    )
    max_new = state.frames.shape[0]
    frame_limit = min(frame_limit, max_new)  # never run past the frames buffer
    tb = trailing.shape[0]
    # Whole-step kernel mode: take the cache's [L, S, KV*D] plane views once
    # for the whole loop (views of the same memory, written in place).
    planes = talker.plane_views(state.cache) if talker.stream_plane_mode(talker_params, tcfg, state.cache) else None

    while state.frame_idx < frame_limit and not bool(state.done):
        idx = state.frame_idx
        semantic_embed = talker.embed_codec(talker_params, state.token)[None, None, :]
        codes = cp.predict_acoustic_codes(cp_params, cpcfg, state.last_hidden, semantic_embed, cp_frame_pack)
        state.frames[idx, 0] = state.token
        state.frames[idx, 1:] = codes

        acoustic_sum = cp.acoustic_embedding_sum(cp_params, codes).to(semantic_embed.dtype)
        text_add = trailing[min(idx, tb - 1)] if idx < trailing_len else pad_embed
        step_input = semantic_embed + acoustic_sum + text_add.to(semantic_embed.dtype)[None, None, :]

        if planes is not None:
            hidden, logits = talker.decode_step_planes(talker_params, tcfg, step_input, state.pos, *planes)
        else:
            hidden, logits = talker.decode_step(talker_params, tcfg, step_input, state.pos, state.cache)

        token_count = idx + 1
        logits = sampling.apply_generation_penalties(
            logits, state.penalty_mask, suppression, scfg, token_count
        )
        next_token = sampling.sample(logits, scfg, uniforms[min(token_count, max_new)])[0]
        state.penalty_mask[next_token] = 1.0

        state.last_hidden = hidden
        state.token = next_token
        state.frame_idx = token_count
        state.pos += 1
        state.done = next_token == scfg.eos_token_id
    return state
