"""Code predictor: 5-layer decoder emitting 15 acoustic codes per frame.

PyTorch port of ``qwen3_tts_tpu/models/code_predictor.py``. Per frame:
  1. run the stack over [talker_hidden, semantic_embed] (projected
     2048 -> 1024 on 1.7B models),
  2. greedy-predict acoustic code 0 from lm_head[0] at the last position,
  3. 14 single-token steps: embed the previous code with the previous
     group's table, run the stack, predict with the group's head.

Everything is argmax, so a frame is deterministic given the talker hidden
state. ``predict_acoustic_codes`` takes the JAX package's route for the
tree, chosen before any launch by the JAX package's gates:
  * the whole-frame kernel (``ops/fused_layer.cp_frame``, one call per
    frame) when ``supports_cp_frame_kernel``;
  * else, for a fused int8 tree, the per-step path
    (``_predict_acoustic_codes_fused``): a 2-row prefill, then 14 decode
    steps of kernel 7 (``streamed_decode_step``, one launch a step) when the
    layer dims tile by the hidden size, or of kernels 5 + 6 per layer
    otherwise (one launch a sub-layer);
  * else the plain layer path (plain PyTorch on every device).
A route whose kernel does not take the shapes raises. On the CPU every
kernel's plain version runs.
"""

from __future__ import annotations

import torch

from ..ops import fused_layer, nn, quant
from .config import CodePredictorConfig

CP_MAX_SEQ = fused_layer.CP_MAX_SEQ


def cp_route(params: dict, cfg: CodePredictorConfig) -> str:
    """The route ``predict_acoustic_codes`` takes for this tree: "frame"
    (kernel 1), "streamed_step" (kernel 7 per step), "layer_steps" (kernels
    5 + 6 per layer and step) or "layers" (the plain layer path)."""
    if fused_layer.supports_cp_frame_kernel(params, cfg):
        return "frame"
    layers = params["layers"]
    if fused_layer.supports_fused_step(layers):
        return "streamed_step" if fused_layer.has_stream_pack(layers, cfg.hidden_size) else "layer_steps"
    return "layers"


def predict_acoustic_codes(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
    frame_pack: fused_layer.CpFramePack | None = None,
    step_pack: fused_layer.CpStepPack | fused_layer.FusedStepPack | None = None,
) -> torch.Tensor:
    """All 15 acoustic codes for one frame.

    talker_hidden, semantic_embed: [1, 1, embed_dim] (talker hidden size).
    ``frame_pack``: the tree's ``fused_layer.CpFramePack`` for the frame
    kernel; ``step_pack``: its ``fused_layer.CpStepPack`` for kernel 7, or
    its ``fused_layer.FusedStepPack`` for kernels 5 + 6 (each built per
    call when None). Returns int32 [num_acoustic] on the inputs' device.
    """
    route = cp_route(params, cfg)
    if route == "frame":
        return fused_layer.cp_frame(params, cfg, talker_hidden, semantic_embed, frame_pack)
    if route == "layers":
        return fused_layer.cp_frame_layers(params, cfg, talker_hidden, semantic_embed, quant.mm)
    return _predict_acoustic_codes_fused(params, cfg, talker_hidden, semantic_embed, step_pack=step_pack)


def _predict_acoustic_codes_fused(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
    streamed: bool | None = None,
    step_pack: fused_layer.CpStepPack | fused_layer.FusedStepPack | None = None,
) -> torch.Tensor:
    """The per-step int8 frame (the JAX package's fused variant).

    The 2-row prefill runs the layer stack (its projections through
    ``quant.mm``: kernel 4 on the card); the cache is then viewed once as
    [L, S, KV*D] planes, and each of the 14 decode steps takes one route of
    ``fused_layer.run_fused_decode_step``, written in place in the planes.
    ``streamed``: kernel 7 (True, through ``step_pack``, a ``CpStepPack``)
    or kernels 5 + 6 per layer (False, through ``step_pack``, a
    ``FusedStepPack``); None takes the JAX package's choice, kernel 7 exactly
    when it would hold a stream pack (``has_stream_pack``).
    """
    stack = cfg.layer_stack()
    layers = params["layers"]
    dev = talker_hidden.device
    if streamed is None:
        streamed = fused_layer.has_stream_pack(layers, stack.hidden_size)
    cache = nn.init_kv_cache(stack, 1, CP_MAX_SEQ, talker_hidden.dtype, dev)
    x = fused_layer.mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    h = nn.run_layer_stack(layers, x, stack, cache, torch.arange(2, device=dev), 0, self_attn_prefill=True)
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    heads = params["lm_heads"]
    code = torch.argmax(quant.mm(h[:, 1], fused_layer.head(heads, 0)), dim=-1)  # [1]
    codes = [code]

    kvd = stack.num_kv_heads * stack.head_dim
    ck = cache.k.view(stack.num_layers, CP_MAX_SEQ, kvd)
    cv = cache.v.view(stack.num_layers, CP_MAX_SEQ, kvd)
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, CP_MAX_SEQ, dev)
    # Per-layer weight views, taken once per frame for kernels 5 + 6.
    views = None if streamed else [nn.layer_params_at(layers, l) for l in range(stack.num_layers)]
    for g in range(1, cfg.num_acoustic):
        pos = g + 1
        x = fused_layer.mtp_project(params, params["codec_embeddings"][g - 1][code][None])
        h = fused_layer.run_fused_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t, streamed, views, step_pack)
        h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
        code = torch.argmax(quant.mm(h[:, 0], fused_layer.head(heads, g)), dim=-1)
        codes.append(code)
    return torch.cat(codes).to(torch.int32)


def predict_acoustic_codes_batch(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
) -> torch.Tensor:
    """The acoustic codes of B frames at once (talker_hidden,
    semantic_embed: [B, 1, embed_dim]) -> int32 [B, num_acoustic].

    Always the layer path (``fused_layer.cp_frame_layers_batch``, every
    projection and head through ``quant.mm``: kernel 4 at B rows on an int8
    tree on the card), whatever ``cp_route`` says: kernels 1, 5, 6 and 7 are
    batch-1, and the JAX package's batched programs take its generic stack
    for the same reason (their stream pack stripped, its Pallas dequant off).
    """
    return fused_layer.cp_frame_layers_batch(params, cfg, talker_hidden, semantic_embed, quant.mm)


def acoustic_embedding_sum(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """Sum of per-group embeddings of a frame's acoustic codes.

    codes: int [num_acoustic] (or [B, num_acoustic], B frames). Returns [1,
    1, embed_dim] ([B, 1, embed_dim]): one batched gather over the stacked
    [G, vocab, dim] tables, summed in f32 accumulation.
    """
    tables = params["codec_embeddings"]  # [G, vocab, dim]
    groups = torch.arange(tables.shape[0], device=tables.device)
    return tables[groups, codes.reshape(-1, tables.shape[0]).long()].sum(dim=1)[:, None]
