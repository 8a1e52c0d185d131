"""Talker model: 28-layer GQA decoder generating semantic codec tokens.

PyTorch port of the CustomVoice path of ``qwen3_tts_tpu/models/talker.py``
(dual text/codec embeddings, SiLU text projection, final norm + codec head).
The prefill runs on the layer path (``ops/nn.py``, plain or int8 weights,
fused or not). A decode step on a fused tree (all int8, or all plain: what
the JAX package would stream-pack) runs the whole-step kernel on the
cache's [L, S, KV*D] plane view (``stream_plane_mode``,
``decode_step_planes``); on an unfused tree, the layer path. The
tensor-parallel and ICL variants of the JAX module are not ported yet.

CustomVoice prompt layout, 10 positions:
    [0..3)  text_proj(text_emb([im_start, assistant, newline]))
    [3..9)  text_proj(text_emb([pad x5, bos])) + codec_emb([think, think_bos,
            lang, think_eos, speaker, codec_pad])
    [9]     text_proj(text_emb(first_text)) + codec_emb(codec_bos)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import fused_layer, nn
from ..ops.quant import mm
from . import tokens as T
from .config import TalkerConfig


def _ids(params: dict, vals) -> torch.Tensor:
    """Python ints (or 0-d tensors) -> an int64 id vector on the params' device."""
    dev = params["codec_embedding"].device
    return torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev) for v in vals])


def text_project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Text projection: fc1 -> SiLU -> fc2 (both with bias)."""
    tp = params["text_projection"]
    h = F.silu(x @ tp["fc1_w"] + tp["fc1_b"])
    return h @ tp["fc2_w"] + tp["fc2_b"]


def embed_text(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Projected text embeddings for token ids of any shape -> [..., hidden]."""
    return text_project(params, params["text_embedding"][ids])


def embed_codec(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Codec-vocabulary embeddings [..., hidden]."""
    return params["codec_embedding"][ids]


def build_custom_voice_prompt(
    params: dict, first_text_id: torch.Tensor, speaker_id, lang_id
) -> torch.Tensor:
    """CustomVoice prompt embedding [1, 10, hidden]."""
    role = embed_text(params, _ids(params, [T.IM_START, T.ASSISTANT, T.NEWLINE]))
    codec_ids = _ids(
        params,
        [T.CODEC_THINK, T.CODEC_THINK_BOS, lang_id, T.CODEC_THINK_EOS, speaker_id, T.CODEC_PAD],
    )
    overlay_text = embed_text(params, _ids(params, [T.TTS_PAD] * 5 + [T.TTS_BOS]))
    overlay = overlay_text + embed_codec(params, codec_ids)
    first = embed_text(params, first_text_id.reshape(1)) + embed_codec(
        params, _ids(params, [T.CODEC_BOS])
    )
    return torch.cat([role, overlay, first], dim=0)[None]


def build_trailing_text(params: dict, text_ids: torch.Tensor, text_len: int) -> torch.Tensor:
    """Per-frame text-fusion rows [Tb, hidden], right-filled with tts_pad.

    Row i holds text token i+1 for i < text_len-1, tts_eos at i = text_len-1,
    and tts_pad beyond (static bucket length Tb = text_ids.shape[0]).
    """
    tb = text_ids.shape[0]
    emb = embed_text(params, text_ids)  # [Tb, hidden]
    shifted = torch.cat([emb[1:], torch.zeros_like(emb[:1])], dim=0)
    eos = embed_text(params, _ids(params, [T.TTS_EOS]))
    pad = embed_text(params, _ids(params, [T.TTS_PAD]))
    idx = torch.arange(tb, device=emb.device)[:, None]
    return torch.where(idx < text_len - 1, shifted, torch.where(idx == text_len - 1, eos, pad))


def tts_pad_embed(params: dict) -> torch.Tensor:
    """[1, hidden] projected tts_pad embedding (post-trailing filler)."""
    return embed_text(params, _ids(params, [T.TTS_PAD]))


def forward(
    params: dict,
    cfg: TalkerConfig,
    x: torch.Tensor,
    cache: nn.KVCache,
    positions: torch.Tensor,
    write_pos: int,
    self_attn_prefill: bool = False,
) -> torch.Tensor:
    """Run the layer stack on embeddings x [1, S, hidden]; returns normed hidden."""
    h = nn.run_layer_stack(
        params["layers"], x, cfg.layer_stack(), cache, positions, write_pos,
        self_attn_prefill=self_attn_prefill,
    )
    return nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)


def codec_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Codec head on (already normed) hidden states: [..., codec_vocab]."""
    return mm(hidden, params["codec_head"])


def prefill(
    params: dict,
    cfg: TalkerConfig,
    prompt: torch.Tensor,
    prefill_len: int,
    cache: nn.KVCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh-cache prefill of a right-padded prompt embedding [1, Pb, hidden].

    Attention reads only the prompt's own rows (S x S). Writes the cache in
    place. Returns (last_hidden [1,1,hidden] normed, logits [1, codec_vocab]
    at the last valid position).
    """
    positions = torch.arange(prompt.shape[1], device=prompt.device)
    h = forward(params, cfg, prompt, cache, positions, 0, self_attn_prefill=True)
    last = h[:, prefill_len - 1 : prefill_len]
    return last, codec_logits(params, last)[:, 0, :]


def stream_plane_mode(params: dict, cfg: TalkerConfig, cache: nn.KVCache) -> bool:
    """True when decode steps run the whole-step kernel, which takes the
    cache as [L, S, KV*D] planes: a fused tree, all int8 or all plain, whose
    dims tile by the hidden size (the JAX package's ``make_stream_pack``
    gate: in the JAX package the pack's presence is the gate, in the port
    the fused tree stands for the pack), a batch-1 cache, at most
    ``TALKER_STREAM_MAX_SEQ`` rows, and shapes the kernel's plan takes
    (``fused_layer.supports_talker_step_kernel``; else the layer path).

    Callers that loop decode steps (``generation/core.py``) take the plane
    views once per loop; the cache is contiguous, so the views are free.
    """
    return (
        fused_layer.has_stream_pack(params["layers"], cfg.hidden_size)
        and cache.k.ndim == 5
        and cache.k.shape[1] == 1
        and cache.max_seq <= fused_layer.TALKER_STREAM_MAX_SEQ
        and fused_layer.supports_talker_step_kernel(params["layers"], cfg, cache.max_seq)
    )


def plane_views(cache: nn.KVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, S, KV*D] views of a batch-1 cache [L, 1, S, KV, D] (no copy)."""
    layers, _, seq, kv, d = cache.k.shape
    return cache.k.view(layers, seq, kv * d), cache.v.view(layers, seq, kv * d)


def decode_step_planes(
    params: dict,
    cfg: TalkerConfig,
    step_embed: torch.Tensor,
    pos: int,
    ck: torch.Tensor,
    cv: torch.Tensor,
    pack: fused_layer.TalkerStepPack | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole-step kernel generation step on the plane views [L, S, KV*D]
    (row ``pos`` written in place), through the tree's ``pack`` on the card
    when given. Returns (normed hidden [1,1,hidden], logits [1,
    codec_vocab])."""
    h = fused_layer.talker_step(params["layers"], step_embed, cfg.layer_stack(), ck, cv, pos, pack)
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    return h, codec_logits(params, h)[:, 0, :]


def decode_step(
    params: dict,
    cfg: TalkerConfig,
    step_embed: torch.Tensor,
    pos: int,
    cache: nn.KVCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One generation step with a pre-fused input embedding [1, 1, hidden].

    Writes cache row ``pos`` in place. With a fused tree and a cache the
    kernel takes (``stream_plane_mode``) the whole step is one
    ``fused_layer.talker_step`` (int8 or plain weights); otherwise the layer
    path. Returns (normed hidden [1,1,hidden], logits [1, codec_vocab]).
    """
    if stream_plane_mode(params, cfg, cache):
        return decode_step_planes(params, cfg, step_embed, pos, *plane_views(cache))
    positions = torch.full((1,), pos, dtype=torch.int64, device=step_embed.device)
    h = forward(params, cfg, step_embed, cache, positions, pos)
    return h, codec_logits(params, h)[:, 0, :]
