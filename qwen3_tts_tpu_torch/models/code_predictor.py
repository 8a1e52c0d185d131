"""Code predictor: 5-layer decoder emitting 15 acoustic codes per frame.

PyTorch port of ``qwen3_tts_tpu/models/code_predictor.py``. Per frame:
  1. run the stack over [talker_hidden, semantic_embed] (projected
     2048 -> 1024 on 1.7B models),
  2. greedy-predict acoustic code 0 from lm_head[0] at the last position,
  3. 14 single-token steps: embed the previous code with the previous
     group's table, run the stack, predict with the group's head.

Everything is argmax, so a frame is deterministic given the talker hidden
state. ``predict_acoustic_codes`` takes the route ``cp_route`` names for
the tree and config, chosen before any launch:
  * ``decode_mode="jacobi"``: Jacobi fixed-point decoding
    (``predict_acoustic_codes_jacobi``: the whole 16-row frame through the
    no-cache stack, repeated until the codes stop changing; every
    projection through ``quant.mm``, so kernel 4 on an int8 tree on the
    card), over every other route, as the JAX frame loop takes it;
  * else (``"sequential"``) the JAX package's gates: the whole-frame kernel
    (``ops/fused_layer.cp_frame``, one call per frame) when
    ``supports_cp_frame_kernel``;
  * else, for a fused int8 tree, the per-step path
    (``_predict_acoustic_codes_fused``): a 2-row prefill, then 14 decode
    steps of kernel 7 (``streamed_decode_step``, one launch a step) when the
    layer dims tile by the hidden size, or of kernels 5 + 6 per layer
    otherwise (one launch a sub-layer);
  * else the plain layer path (plain PyTorch on every device).
A route whose kernel does not take the shapes raises, and so does another
``decode_mode``. On the CPU every kernel's plain version runs.
"""

from __future__ import annotations

import torch

from ..ops import fused_layer, nn, quant
from .config import CodePredictorConfig

CP_MAX_SEQ = fused_layer.CP_MAX_SEQ


def cp_route(params: dict, cfg: CodePredictorConfig) -> str:
    """The route ``predict_acoustic_codes`` takes for this tree: "jacobi"
    (``cfg.decode_mode == "jacobi"``, whatever the tree), "frame" (kernel 1),
    "streamed_step" (kernel 7 per step), "layer_steps" (kernels 5 + 6 per
    layer and step) or "layers" (the plain layer path). A ``decode_mode``
    other than "sequential" and "jacobi" raises."""
    if cfg.decode_mode == "jacobi":
        return "jacobi"
    if cfg.decode_mode != "sequential":
        raise ValueError(f"unknown code-predictor decode_mode {cfg.decode_mode!r} (sequential or jacobi)")
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
    if route == "jacobi":
        return predict_acoustic_codes_jacobi(params, cfg, talker_hidden, semantic_embed)
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

    ``decode_mode="jacobi"``: ``predict_acoustic_codes_jacobi_batch``. Else
    always the layer path (``fused_layer.cp_frame_layers_batch``, every
    projection and head through ``quant.mm``: kernel 4 at B rows on an int8
    tree on the card), whatever ``cp_route`` says: kernels 1, 5, 6 and 7 are
    batch-1, and the JAX package's batched programs take its generic stack
    for the same reason (their stream pack stripped, its Pallas dequant off).
    """
    if cp_route(params, cfg) == "jacobi":
        return predict_acoustic_codes_jacobi_batch(params, cfg, talker_hidden, semantic_embed)
    return fused_layer.cp_frame_layers_batch(params, cfg, talker_hidden, semantic_embed, quant.mm)


# The JAX package's default bound on Jacobi iterations a frame.
JACOBI_MAX_ITERS = 16


def jacobi_logits(params: dict, cfg: CodePredictorConfig, prefix: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """One Jacobi pass of B frames: ``prefix`` [B, 2, hidden] (projected),
    ``codes`` [B, G] -> each code's logits [B, G, vocab] given them.

    Rows 2..G embed codes 0..G-2 with their group tables; the 16-row frame
    runs the no-cache stack; row 1 + g predicts code g with head g. The 15
    heads are one product, as the JAX package's einsum: a quantized stack
    {"q8": [G, H, V], "scale": [G, V]} gives f32 logits (exact bf16 x int8
    products summed in f32, then scaled), a plain one logits in its dtype.
    """
    n = cfg.num_acoustic
    groups = torch.arange(n - 1, device=codes.device)
    embs = fused_layer.mtp_project(params, params["codec_embeddings"][groups, codes[:, : n - 1]])  # [B, G-1, hidden]
    h = nn.run_layer_stack_nocache(params["layers"], torch.cat([prefix, embs], dim=1), cfg.layer_stack())
    hg = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)[:, 1 : 1 + n]  # [B, G, hidden]
    heads = params["lm_heads"]
    if quant.is_quantized(heads):
        return torch.einsum("bgh,ghv->bgv", hg.float(), heads["q8"].float()) * heads["scale"]
    return torch.einsum("bgh,ghv->bgv", hg, heads)


def predict_acoustic_codes_jacobi_batch(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
    max_iters: int = JACOBI_MAX_ITERS,
) -> torch.Tensor:
    """Greedy fixed-point (Jacobi) decoding of B frames (talker_hidden,
    semantic_embed: [B, 1, embed_dim]) -> int32 [B, num_acoustic].

    The first pass runs on zero codes; then every stream iterates while its
    codes changed and its count is below ``max_iters``, and once at its
    fixed point its codes and count freeze (the JAX package's ``jax.vmap``
    of its ``while_loop``); the loop ends when every stream has frozen.
    Position g's logits depend only on rows < g (causal, argmax), so after k
    passes the first k codes are the sequential ones: the fixed point is the
    sequential greedy frame. Each pass reads the device once (whether a
    stream is still live), but the first, which needs no read.
    ``predict_acoustic_codes_jacobi.iterations`` counts the passes (one over
    the weights for all B streams).
    """
    prefix = fused_layer.mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    b = prefix.shape[0]
    codes = torch.argmax(jacobi_logits(params, cfg, prefix, prefix.new_zeros((b, cfg.num_acoustic), dtype=torch.long)),
                         dim=-1)
    active = torch.ones(b, dtype=torch.bool, device=prefix.device)
    passes = 1
    # The first test holds for every stream (codes never equal the JAX loop's -1 start).
    while passes < max_iters and (passes == 1 or bool(active.any())):
        new = torch.argmax(jacobi_logits(params, cfg, prefix, codes), dim=-1)
        changed = (new != codes).any(dim=1)
        codes = torch.where(active[:, None], new, codes)
        active &= changed
        passes += 1
    predict_acoustic_codes_jacobi.iterations += passes
    return codes.to(torch.int32)


def predict_acoustic_codes_jacobi(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
    max_iters: int = JACOBI_MAX_ITERS,
) -> torch.Tensor:
    """Greedy fixed-point (Jacobi) decoding of one frame's acoustic codes
    (the JAX package's ``predict_acoustic_codes_jacobi``): talker_hidden,
    semantic_embed [1, 1, embed_dim] -> int32 [num_acoustic]. One pass over
    the weights an iteration instead of 15 steps; at most ``max_iters``.
    ``predict_acoustic_codes_jacobi.iterations`` counts the passes run
    (instrumentation, as a kernel wrapper's ``launches``)."""
    return predict_acoustic_codes_jacobi_batch(params, cfg, talker_hidden, semantic_embed, max_iters)[0]


predict_acoustic_codes_jacobi.iterations = 0


def acoustic_embedding_sum(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """Sum of per-group embeddings of a frame's acoustic codes.

    codes: int [num_acoustic] (or [B, num_acoustic], B frames). Returns [1,
    1, embed_dim] ([B, 1, embed_dim]): one batched gather over the stacked
    [G, vocab, dim] tables, summed in f32 accumulation.
    """
    tables = params["codec_embeddings"]  # [G, vocab, dim]
    groups = torch.arange(tables.shape[0], device=tables.device)
    return tables[groups, codes.reshape(-1, tables.shape[0]).long()].sum(dim=1)[:, None]


def embed_codes_for_group(params: dict, group_idx: int, codes: torch.Tensor) -> torch.Tensor:
    """Embed a [T] code sequence with acoustic group ``group_idx``'s table -> [1, T, dim]."""
    return params["codec_embeddings"][group_idx][codes.long()][None]
