"""Talker model: 28-layer GQA decoder generating semantic codec tokens.

PyTorch port of ``qwen3_tts_tpu/models/talker.py`` (dual text/codec
embeddings, SiLU text projection, the prompt layouts of the three variants,
final norm + codec head). The prefill runs on the layer path
(``ops/nn.py``, plain or int8 weights, fused or not); on the card a batch-1
prefill of a prompt whose rows are all live replays it as one CUDA graph
where the caller hands one in (``PrefillGraph``, ``prefill_graph_key``:
the CustomVoice and x-vector prompts' 10 rows). A decode step on a
fused tree (all int8, or all plain: what the JAX package would stream-pack)
runs the whole-step kernel on the cache's [L, S, KV*D] plane view
(``stream_plane_mode``, ``decode_step_planes``) while the cache holds at
most ``TALKER_STREAM_MAX_SEQ`` rows; otherwise, and on an unfused tree, the
layer path. Batched synthesis (``prefill_batch``, ``decode_step_batch``:
B streams, each at its own position) always takes the layer path.

On a tensor-parallel tree (``parallel.sharding.ShardedTree``: one replica's
ranks, made by ``Qwen3TTS.shard``) every function here splits its work over
the ranks as GSPMD does under ``sharding.talker_specs``: the text
projection's fc1 column-split and fc2 row-split (an all-reduce before the
bias), the layer stack on ``nn.run_layer_stack_tp``, the codec head split by
vocabulary with its logits gathered on the replica's first device, where the
embeddings and the final norm are read whole. A batch-1 decode step of an
int8 tree with the tp re-layout runs kernels 5 and 6 on every rank
(``tp_plane_mode``, ``decode_step_planes_tp``); the whole-step kernel is
never taken under a mesh.

Prompt layouts (each row of the prompt embedding is one position):

CustomVoice, 10 positions:
    [0..3)  text_proj(text_emb([im_start, assistant, newline]))
    [3..9)  text_proj(text_emb([pad x5, bos])) + codec_emb([think, think_bos,
            lang, think_eos, speaker, codec_pad])
    [9]     text_proj(text_emb(first_text)) + codec_emb(codec_bos)

VoiceClone: as CustomVoice, but the speaker slot holds the continuous
x-vector instead of codec_emb(speaker); in ICL mode the final (first_text +
codec_bos) position is left out (9 positions) and the ICL rows follow
(``build_icl_rows``: text and reference codec rows overlaid;
``build_icl_rows_sequential``: a text block, then a codec block).

VoiceDesign: the ChatML instruct rows first; no speaker slot (the overlay is
pad x4 + bos over [think, think_bos, lang, think_eos, codec_pad]); 9
positions after the instruct (``build_voice_design_suffix``).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..ops import fused_layer, nn, quant
from ..ops.quant import mm
from ..parallel import collectives
from ..parallel.sharding import ShardedTree
from . import tokens as T
from .config import TalkerConfig


def _ids(params: dict, vals) -> torch.Tensor:
    """Python ints (or 0-d tensors) -> an int64 id vector on the params' device."""
    dev = params["codec_embedding"].device
    return torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev) for v in vals])


def text_project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Text projection: fc1 -> SiLU -> fc2 (both with bias)."""
    if isinstance(params, ShardedTree):
        xs = collectives.broadcast(x, params.devices)
        hidden = []
        for r, xr, dev in zip(params.ranks, xs, params.devices):
            with collectives.device_scope(dev):
                hidden.append(F.silu(xr @ r["text_projection"]["fc1_w"] + r["text_projection"]["fc1_b"]))
        fc2 = [r["text_projection"]["fc2_w"] for r in params.ranks]
        return nn.row_parallel(hidden, fc2, params.devices)[0] + params["text_projection"]["fc2_b"]
    tp = params["text_projection"]
    h = F.silu(x @ tp["fc1_w"] + tp["fc1_b"])
    return h @ tp["fc2_w"] + tp["fc2_b"]


def embed_text(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Projected text embeddings for token ids of any shape -> [..., hidden]."""
    return text_project(params, params["text_embedding"][ids])


def embed_codec(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Codec-vocabulary embeddings [..., hidden]."""
    return params["codec_embedding"][ids]


def _role_prefix(params: dict) -> torch.Tensor:
    """[3, hidden] projected embeddings of <|im_start|>assistant\\n."""
    return embed_text(params, _ids(params, [T.IM_START, T.ASSISTANT, T.NEWLINE]))


def _first_row(params: dict, first_text_id: torch.Tensor) -> torch.Tensor:
    """[1, hidden]: the first text token over codec_bos."""
    return embed_text(params, first_text_id.reshape(1)) + embed_codec(params, _ids(params, [T.CODEC_BOS]))


def build_custom_voice_prompt(
    params: dict, first_text_id: torch.Tensor, speaker_id, lang_id
) -> torch.Tensor:
    """CustomVoice prompt embedding [1, 10, hidden]."""
    role = _role_prefix(params)
    codec_ids = _ids(
        params,
        [T.CODEC_THINK, T.CODEC_THINK_BOS, lang_id, T.CODEC_THINK_EOS, speaker_id, T.CODEC_PAD],
    )
    overlay_text = embed_text(params, _ids(params, [T.TTS_PAD] * 5 + [T.TTS_BOS]))
    overlay = overlay_text + embed_codec(params, codec_ids)
    return torch.cat([role, overlay, _first_row(params, first_text_id)], dim=0)[None]


def build_voice_clone_prompt(
    params: dict,
    first_text_id: torch.Tensor,
    speaker_embed: torch.Tensor,
    lang_id: int,
    icl_mode: bool,
) -> torch.Tensor:
    """VoiceClone prompt embedding [1, 10, hidden] (or [1, 9, hidden] in ICL).

    ``speaker_embed``: [hidden] continuous x-vector replacing the discrete
    speaker token embedding.
    """
    prefix = embed_codec(params, _ids(params, [T.CODEC_THINK, T.CODEC_THINK_BOS, lang_id, T.CODEC_THINK_EOS]))
    pad = embed_codec(params, _ids(params, [T.CODEC_PAD]))
    codec_rows = torch.cat([prefix, speaker_embed.to(prefix.dtype)[None], pad], dim=0)
    overlay = embed_text(params, _ids(params, [T.TTS_PAD] * 5 + [T.TTS_BOS])) + codec_rows
    rows = [_role_prefix(params), overlay]
    if not icl_mode:
        rows.append(_first_row(params, first_text_id))
    return torch.cat(rows, dim=0)[None]


def build_voice_design_suffix(params: dict, first_text_id: torch.Tensor, lang_id) -> torch.Tensor:
    """VoiceDesign post-instruct rows [9, hidden]: role(3) + overlay(5) + first(1)."""
    codec_ids = _ids(params, [T.CODEC_THINK, T.CODEC_THINK_BOS, lang_id, T.CODEC_THINK_EOS, T.CODEC_PAD])
    overlay = embed_text(params, _ids(params, [T.TTS_PAD] * 4 + [T.TTS_BOS])) + embed_codec(params, codec_ids)
    return torch.cat([_role_prefix(params), overlay, _first_row(params, first_text_id)], dim=0)


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


def build_icl_rows(
    params: dict,
    all_text_ids: torch.Tensor,  # [Tb] ref_text + target_text + tts_eos, padded
    n_text: int,  # true text length (incl. tts_eos)
    codec_rows: torch.Tensor,  # [Cb, hidden] codec_bos + summed ref codec embeds
    n_codec: int,  # true codec row count
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """ICL prompt rows (the streaming element-wise overlay).

    The ICL block has ``n_codec`` true rows: row i = codec_rows[i] +
    (text_emb[i] if i < n_text else tts_pad). Text tokens beyond n_codec
    become per-frame trailing context. Returns (icl_rows [1, Cb, hidden]
    right-padded, trailing [Tb, hidden], trailing_len).
    """
    tb, cb = all_text_ids.shape[0], codec_rows.shape[0]
    text_emb = embed_text(params, all_text_ids)  # [Tb, hidden]
    pad = tts_pad_embed(params)[0]
    dev = text_emb.device
    ci = torch.arange(cb, device=dev)
    text_part = torch.where((ci < min(n_text, tb))[:, None], text_emb[ci.clamp(max=tb - 1)], pad)
    # trailing[i] = text_emb[n_codec + i] for i < n_text - n_codec, else pad
    ti = torch.arange(tb, device=dev)
    trailing = torch.where((ti < n_text - n_codec)[:, None], text_emb[(ti + n_codec).clamp(0, tb - 1)], pad)
    return (codec_rows + text_part)[None], trailing, max(n_text - n_codec, 0)


def build_icl_rows_sequential(
    params: dict,
    all_text_ids: torch.Tensor,  # [Tb] ref_text + target_text + tts_eos, padded
    n_text: int,
    codec_rows: torch.Tensor,  # [Cb, hidden] codec_bos + summed ref codec embeds
    n_codec: int,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The non-streaming ICL layout: two blocks instead of an overlay,
    ``[text + codec_pad (n_text rows) || codec + tts_pad (n_codec rows)]``;
    all text is consumed in the prompt, so the trailing rows are tts_pad.
    Returns (icl_rows [1, Tb+Cb, hidden] right-padded, true length n_text +
    n_codec; trailing [1, hidden]; trailing_len 0).
    """
    tb, cb = all_text_ids.shape[0], codec_rows.shape[0]
    text_block = embed_text(params, all_text_ids) + embed_codec(params, _ids(params, [T.CODEC_PAD]))[0]
    pad = tts_pad_embed(params)[0]
    rows = text_block.new_zeros((tb + cb, text_block.shape[-1]))
    rows[:tb] = text_block
    # The codec block starts right after the true text length, over any
    # padded text rows; the padding stays strictly to the right.
    rows[n_text:n_text + cb] = codec_rows + pad
    return rows[None], pad[None], 0


def tts_pad_embed(params: dict) -> torch.Tensor:
    """[1, hidden] projected tts_pad embedding (post-trailing filler)."""
    return embed_text(params, _ids(params, [T.TTS_PAD]))


def forward(
    params: dict,
    cfg: TalkerConfig,
    x: torch.Tensor,
    cache: nn.KVCache,
    positions: torch.Tensor,
    write_pos: int | torch.Tensor,
    self_attn_prefill: bool = False,
    tables: tuple | None = None,
) -> torch.Tensor:
    """Run the layer stack on embeddings x [B, S, hidden] (``positions``,
    ``write_pos`` and ``tables`` as ``nn.run_layer_stack`` takes them);
    returns normed hidden. A sharded tree takes ``nn.run_layer_stack_tp`` on
    its ranks' layers and an ``nn.TPCache``."""
    if isinstance(params, ShardedTree):
        h = nn.run_layer_stack_tp([r["layers"] for r in params.ranks], params.devices, x, cfg.layer_stack(),
                                  list(cache.parts), positions, write_pos, self_attn_prefill=self_attn_prefill)
    else:
        h = nn.run_layer_stack(params["layers"], x, cfg.layer_stack(), cache, positions, write_pos,
                               self_attn_prefill=self_attn_prefill, tables=tables)
    return nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)


def codec_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Codec head on (already normed) hidden states: [..., codec_vocab]; on a
    sharded tree each rank's vocabulary slice, gathered on the first device."""
    if isinstance(params, ShardedTree):
        hs = collectives.broadcast(hidden, params.devices)
        parts = []
        for r, h, dev in zip(params.ranks, hs, params.devices):
            with collectives.device_scope(dev):
                parts.append(mm(h, r["codec_head"]))
        return collectives.gather(parts, params.devices[0])
    return mm(hidden, params["codec_head"])


def prefill(
    params: dict,
    cfg: TalkerConfig,
    prompt: torch.Tensor,
    prefill_len: int,
    cache: nn.KVCache,
    graph: PrefillGraph | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh-cache prefill of a right-padded prompt embedding [1, Pb, hidden].

    Attention reads only the prompt's own rows (S x S). Writes the cache in
    place. Returns (last_hidden [1,1,hidden] normed, logits [1, codec_vocab]
    at the last valid position). ``graph``: a ``PrefillGraph``, replayed
    where it fits the call (``graph_fits``); otherwise, and without one, the
    eager layer path.
    """
    if graph_fits(graph, params, prompt, prefill_len, cache):
        return graph.replay(prompt, cache)
    return prefill_batch(params, cfg, prompt, [prefill_len], cache)


def prefill_batch(
    params: dict,
    cfg: TalkerConfig,
    prompt: torch.Tensor,
    prefill_lens: list[int],
    cache: nn.KVCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``prefill`` of B prompts right-padded to one bucket [B, Pb, hidden]
    (the causal S x S prefill is exact for each stream; ``cache`` holds B
    streams). Stream b's last hidden is read at ``prefill_lens[b] - 1``.
    Returns (last_hidden [B,1,hidden] normed, logits [B, codec_vocab])."""
    positions = torch.arange(prompt.shape[1], device=prompt.device)
    h = forward(params, cfg, prompt, cache, positions, 0, self_attn_prefill=True)
    rows = torch.tensor([n - 1 for n in prefill_lens], device=prompt.device)
    return _last_rows(params, h, torch.arange(h.shape[0], device=prompt.device), rows)


def _last_rows(params: dict, h: torch.Tensor, streams: torch.Tensor, rows: torch.Tensor) -> tuple:
    """Stream b's normed hidden at row ``rows[b]`` [B, 1, hidden] and its
    codec logits [B, codec_vocab]."""
    last = h[streams, rows][:, None]
    return last, codec_logits(params, last)[:, 0, :]


def prefill_graph_key(params: dict, prompt: torch.Tensor, prefill_len: int, cache) -> tuple | None:
    """What a ``PrefillGraph`` must have been captured for to replay this
    prefill: (device, prompt dtype, prompt shape, cache dtype, the tree's
    id). None where the prefill runs eagerly whatever the graph: on a
    sharded tree or a ``TPCache``, at more than one stream, where padding
    rows follow the prompt (``prefill_len`` short of its rows), with the
    cache on another device, or under ``quant.w8a8_scope``. A graph exists
    only on the card, so a CPU prompt's key matches none."""
    if (isinstance(params, ShardedTree) or not isinstance(cache, nn.KVCache) or prompt.shape[0] != 1
            or cache.k.shape[1] != 1 or prefill_len != prompt.shape[1] or cache.k.device != prompt.device
            or quant._w8a8_allowed()):
        return None
    return prompt.device, prompt.dtype, tuple(prompt.shape), cache.k.dtype, id(params)


def graph_fits(graph, params: dict, prompt: torch.Tensor, prefill_len: int, cache) -> bool:
    """Whether ``prefill`` replays ``graph`` (None: never) for this call."""
    return graph is not None and prefill_graph_key(params, prompt, prefill_len, cache) == graph.key


class PrefillGraph:
    """The batch-1 prefill of one tree at one prompt length, captured once
    as a CUDA graph and replayed by ``prefill`` for every call it fits.

    The graph holds the layer stack, the final norm, the last row's pick
    and the codec head, on static buffers: the prompt [1, rows, hidden] in;
    the last hidden [1, 1, hidden], the logits [1, codec_vocab] and the K/V
    rows [L, 1, rows, KV, D] out. The RoPE tables, the mask and the row
    index are made once, before the capture. A replay copies the prompt in,
    replays, copies the K/V rows into the call's cache and returns copies
    of the hidden and the logits (the next replay overwrites the buffers,
    and sessions may be open side by side). It runs the eager prefill's
    kernels on the same inputs, so its results are the eager prefill's.

    The capture is made at the first replay: an eager warm-up on a side
    stream, then ``torch.cuda.graph`` on it. An int8 tree's kernel 4 is
    recorded in the graph; ``quant.int8_matmul.launches`` counts the
    launches each replay makes, and none for the capture, which launches
    nothing.
    """

    def __init__(self, params: dict, cfg: TalkerConfig, rows: int):
        dev, dtype = params["norm"].device, params["norm"].dtype
        if dev.type != "cuda" or isinstance(params, ShardedTree):
            raise ValueError(f"PrefillGraph: a CUDA graph of one card's tree, not of a tree on {dev}")
        self.params, self.cfg, self.rows = params, cfg, rows
        self.key = (dev, dtype, (1, rows, cfg.hidden_size), dtype, id(params))
        self.graph: torch.cuda.CUDAGraph | None = None
        self.k4_launches = 0  # kernel-4 launches a replay makes
        self._lock = threading.Lock()

    @torch.no_grad()
    def _capture(self) -> None:
        dev, dtype, shape, cache_dtype, _ = self.key
        stack = self.cfg.layer_stack()
        self.prompt = torch.zeros(shape, dtype=dtype, device=dev)
        self.kv = nn.init_kv_cache(stack, 1, self.rows, cache_dtype, dev)
        positions = torch.arange(self.rows, device=dev)
        tables = nn.rope_and_mask(stack, self.rows, dev, positions, None, True)
        streams = torch.zeros(1, dtype=torch.int64, device=dev)
        rows = torch.full((1,), self.rows - 1, dtype=torch.int64, device=dev)

        def body():
            h = forward(self.params, self.cfg, self.prompt, self.kv, positions, 0, self_attn_prefill=True,
                        tables=tables)
            return _last_rows(self.params, h, streams, rows)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph, launches = torch.cuda.CUDAGraph(), quant.int8_matmul.launches
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self.last, self.logits = body()
        self.k4_launches, quant.int8_matmul.launches = quant.int8_matmul.launches - launches, launches
        # The graph reads these at their addresses on every replay: they live as long as it does.
        self._inputs = (positions, tables, streams, rows)
        self.graph = graph

    def replay(self, prompt: torch.Tensor, cache: nn.KVCache) -> tuple[torch.Tensor, torch.Tensor]:
        """``prefill``'s result for a call that fits the graph, its K/V rows
        written into ``cache``."""
        with self._lock:
            if self.graph is None:
                self._capture()
            self.prompt.copy_(prompt)
            self.graph.replay()
            quant.int8_matmul.launches += self.k4_launches
            cache.k[:, :, :self.rows].copy_(self.kv.k)
            cache.v[:, :, :self.rows].copy_(self.kv.v)
            return self.last.clone(), self.logits.clone()


def decode_step_batch(
    params: dict,
    cfg: TalkerConfig,
    step_embed: torch.Tensor,
    pos: torch.Tensor,
    cache: nn.KVCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One generation step of B streams [B, 1, hidden], stream b at its own
    position ``pos[b]`` (LongTensor [B]; its cache row written in place), on
    the layer path: the whole-step kernel is batch-1, as the JAX package's
    stream pack is (its batched programs strip it). Returns (normed hidden
    [B,1,hidden], logits [B, codec_vocab])."""
    h = forward(params, cfg, step_embed, cache, pos[:, None], pos)
    return h, codec_logits(params, h)[:, 0, :]


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
    Never on a sharded tree (kernel 3 cannot span ranks).
    """
    return (
        not isinstance(params, ShardedTree)
        and fused_layer.has_stream_pack(params["layers"], cfg.hidden_size)
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


def tp_plane_mode(params: dict, cfg: TalkerConfig, cache, mesh) -> bool:
    """True when decode steps run kernels 5 and 6 on every rank
    (``fused_layer.tp_decode_step``): a mesh, a sharded tree with the tp
    re-layout (``Qwen3TTS.shard`` builds it for an int8 talker when tp > 1),
    a batch-1 ``nn.TPCache`` of at most ``TALKER_STREAM_MAX_SEQ`` rows (the
    rows the ranks' packs take; a larger cache takes the layer path). The
    cache is then carried as each rank's [L, S, KV/tp * D] planes."""
    return (
        mesh is not None
        and isinstance(params, ShardedTree)
        and "tp_pack" in params
        and isinstance(cache, nn.TPCache)
        and cache.parts[0].k.shape[1] == 1
        and cache.max_seq <= fused_layer.TALKER_STREAM_MAX_SEQ
    )


def tp_plane_views(cache: nn.TPCache) -> tuple[list, list]:
    """Every rank's [L, S, KV/tp * D] plane views of a batch-1 ``nn.TPCache``."""
    views = [plane_views(part) for part in cache.parts]
    return [k for k, _ in views], [v for _, v in views]


def decode_step_planes_tp(
    params: ShardedTree,
    cfg: TalkerConfig,
    step_embed: torch.Tensor,
    pos: int,
    cks: list,
    cvs: list,
    packs: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tensor-parallel generation step on the ranks' plane views (row
    ``pos`` written in place): kernels 5 and 6 on every rank through their
    ``packs`` (``fused_layer.tp_step_packs``) on the cards, the plain
    versions on the CPU. Returns (normed hidden [1,1,hidden], logits [1,
    codec_vocab]) on the first device."""
    h = fused_layer.tp_decode_step([r["layers"] for r in params.ranks], [r["tp_pack"] for r in params.ranks],
                                   step_embed, cfg.layer_stack(), cks, cvs, pos, params.devices, packs)
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
    path (on a sharded tree, ``nn.run_layer_stack_tp``). Returns (normed
    hidden [1,1,hidden], logits [1, codec_vocab]).
    """
    if stream_plane_mode(params, cfg, cache):
        return decode_step_planes(params, cfg, step_embed, pos, *plane_views(cache))
    positions = torch.full((1,), pos, dtype=torch.int64, device=step_embed.device)
    h = forward(params, cfg, step_embed, cache, positions, pos)
    return h, codec_logits(params, h)[:, 0, :]
