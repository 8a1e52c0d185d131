"""Code predictor: 5-layer decoder emitting 15 acoustic codes per frame.

PyTorch port of ``qwen3_tts_tpu/models/code_predictor.py``. Per frame:
  1. run the stack over [talker_hidden, semantic_embed] (projected
     2048 -> 1024 on 1.7B models),
  2. greedy-predict acoustic code 0 from lm_head[0] at the last position,
  3. 14 single-token steps: embed the previous code with the previous
     group's table, run the stack, predict with the group's head.

Everything is argmax, so a frame is deterministic given the talker hidden
state. On the card the whole frame is one call of the hand-written kernel
(``ops/fused_layer.cp_frame``); on the CPU it is the plain version.
"""

from __future__ import annotations

import torch

from ..ops import fused_layer
from .config import CodePredictorConfig


def predict_acoustic_codes(
    params: dict,
    cfg: CodePredictorConfig,
    talker_hidden: torch.Tensor,
    semantic_embed: torch.Tensor,
) -> torch.Tensor:
    """All 15 acoustic codes for one frame.

    talker_hidden, semantic_embed: [1, 1, embed_dim] (talker hidden size).
    Returns int32 [num_acoustic] on the inputs' device.
    """
    return fused_layer.cp_frame(params, cfg, talker_hidden, semantic_embed)


def acoustic_embedding_sum(params: dict, codes: torch.Tensor) -> torch.Tensor:
    """Sum of per-group embeddings of a frame's acoustic codes.

    codes: int [num_acoustic]. Returns [1, 1, embed_dim] (one batched gather
    over the stacked [G, vocab, dim] tables, summed in f32 accumulation).
    """
    tables = params["codec_embeddings"]  # [G, vocab, dim]
    groups = torch.arange(tables.shape[0], device=tables.device)
    return tables[groups, codes.long()].sum(dim=0)[None, None]
