"""Prompt assembly + prefill + first-token sampling.

PyTorch port of the CustomVoice path of
``qwen3_tts_tpu/generation/prefill.py``: build the prompt embedding on the
device, run the talker prefill, sample the first semantic token, and return
the generation state with the trailing-text schedule.
"""

from __future__ import annotations

import torch

from ..models import talker
from ..models.config import TalkerConfig
from ..ops import nn, sampling
from . import core


def _finish(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    prompt: torch.Tensor,
    prefill_len: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    trailing: torch.Tensor,
    trailing_len: int,
):
    last, logits = talker.prefill(talker_params, tcfg, prompt, prefill_len, cache)
    state = core.init_state(scfg, logits, last, prefill_len, cache, uniforms, max_new_tokens)
    pad = talker.tts_pad_embed(talker_params)[0]
    return state, trailing, trailing_len, pad


def custom_voice_impl(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,  # [Tb] right-padded
    text_len: int,
    speaker_id: int,  # codec speaker token
    lang_id: int,  # codec language token
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
):
    """Returns (state, trailing [Tb, hidden], trailing_len, pad [hidden])."""
    prompt = talker.build_custom_voice_prompt(talker_params, text_ids[0], speaker_id, lang_id)
    trailing = talker.build_trailing_text(talker_params, text_ids, text_len)
    return _finish(
        talker_params, tcfg, scfg, prompt, prompt.shape[1], cache, uniforms,
        max_new_tokens, trailing, text_len,
    )
