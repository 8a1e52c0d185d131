"""Prompt assembly + prefill + first-token sampling.

PyTorch port of ``qwen3_tts_tpu/generation/prefill.py``, one entry per
prompt layout (CustomVoice, VoiceDesign, x-vector clone, ICL clone): build
the prompt embedding on the device (``*_rows``), run the talker prefill,
sample the first semantic token, and return the generation state with the
trailing-text schedule. Lengths are host ints; prompts are right-padded to
their buckets (the prefill is causal, so the padding rows change nothing
before ``prefill_len``, and decode steps overwrite their cache rows). Each
entry takes the model's ``talker.PrefillGraph``, which the talker's prefill
replays where the prompt fits it (the 10-row CustomVoice and x-vector
prompts on the card); the ``q3.prefill`` span's counter ``graph`` says
whether it did.

Batched synthesis (the JAX package's ``generation/batch.py``) builds each
stream's rows with the same ``*_rows`` builders and prefills them together
(``finish_batch``): one prompt of B streams right-padded to a shared
bucket, stream b's prefill ending at its own length.
"""

from __future__ import annotations

import torch

from .. import profiling
from ..models import talker
from ..models.config import TalkerConfig
from ..ops import nn, sampling
from . import core


def _finish(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    rows: tuple,  # a layout's (prompt [1, Pb, hidden], prefill_len, trailing, trailing_len)
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    span,  # the ``q3.prefill`` span: counter ``graph``, 1 where the talker's prefill replays ``graph``, else 0
    graph: talker.PrefillGraph | None,
):
    prompt, prefill_len, trailing, trailing_len = rows
    span.set("graph", int(talker.graph_fits(graph, talker_params, prompt, prefill_len, cache)))
    last, logits = talker.prefill(talker_params, tcfg, prompt, prefill_len, cache, graph)
    state = core.init_state(scfg, logits, last, prefill_len, cache, uniforms, max_new_tokens)
    pad = talker.tts_pad_embed(talker_params)[0]
    return state, trailing, trailing_len, pad


def finish_batch(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    rows: list[tuple],  # each stream's ``*_rows`` (its prompts share one bucket)
    cache: nn.KVCache,  # B streams
    uniforms: torch.Tensor,  # [B, max_new + 1]
    max_new_tokens: int,
):
    """``_finish`` of B streams in one prefill. Returns
    (``core.BatchGenState``, trailing [B, Tb, hidden], trailing_lens, pad
    [hidden])."""
    prompt = torch.cat([r[0] for r in rows], dim=0)
    prefill_lens = [r[1] for r in rows]
    last, logits = talker.prefill_batch(talker_params, tcfg, prompt, prefill_lens, cache)
    state = core.init_state_batch(scfg, logits, last, prefill_lens, cache, uniforms, max_new_tokens)
    trailing = torch.stack([r[2] for r in rows])
    return state, trailing, [r[3] for r in rows], talker.tts_pad_embed(talker_params)[0]


def custom_voice_rows(talker_params: dict, text_ids: torch.Tensor, text_len: int, speaker_id: int, lang_id: int):
    """The CustomVoice prompt [1, 10, hidden] and its trailing text: (prompt,
    prefill_len, trailing [Tb, hidden], trailing_len)."""
    prompt = talker.build_custom_voice_prompt(talker_params, text_ids[0], speaker_id, lang_id)
    return prompt, prompt.shape[1], talker.build_trailing_text(talker_params, text_ids, text_len), text_len


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
    graph: talker.PrefillGraph | None = None,
):
    """Returns (state, trailing [Tb, hidden], trailing_len, pad [hidden]).
    ``graph``: the model's ``talker.PrefillGraph``, replayed where it fits."""
    with profiling.annotate("q3.prefill") as span:
        rows = custom_voice_rows(talker_params, text_ids, text_len, speaker_id, lang_id)
        return _finish(talker_params, tcfg, scfg, rows, cache, uniforms, max_new_tokens, span, graph)


def voice_design_rows(talker_params: dict, text_ids: torch.Tensor, text_len: int, instruct_ids: torch.Tensor,
                      instruct_len: int, lang_id: int):
    """The instruct rows, then the 9 suffix rows at ``instruct_len``: the
    prompt [1, Ib + 9, hidden], prefill_len ``instruct_len + 9``, and the
    trailing text."""
    instruct_emb = talker.embed_text(talker_params, instruct_ids)  # [Ib, H]
    suffix = talker.build_voice_design_suffix(talker_params, text_ids[0], lang_id)
    prompt = suffix.new_zeros((1, instruct_ids.shape[0] + 9, suffix.shape[-1]))
    prompt[0, :instruct_emb.shape[0]] = instruct_emb
    prompt[0, instruct_len:instruct_len + 9] = suffix
    return prompt, instruct_len + 9, talker.build_trailing_text(talker_params, text_ids, text_len), text_len


def voice_design_impl(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,  # [Tb] right-padded
    text_len: int,
    instruct_ids: torch.Tensor,  # [Ib] right-padded ChatML instruct tokens
    instruct_len: int,
    lang_id: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    graph: talker.PrefillGraph | None = None,
):
    """The instruct rows, then the 9 suffix rows at ``instruct_len``; the
    prompt is [1, Ib + 9, hidden]."""
    with profiling.annotate("q3.prefill") as span:
        rows = voice_design_rows(talker_params, text_ids, text_len, instruct_ids, instruct_len, lang_id)
        return _finish(talker_params, tcfg, scfg, rows, cache, uniforms, max_new_tokens, span, graph)


def voice_clone_xvector_rows(talker_params: dict, text_ids: torch.Tensor, text_len: int,
                             speaker_embed: torch.Tensor, lang_id: int):
    """The x-vector prompt [1, 10, hidden] (``speaker_embed`` [hidden] at
    the speaker slot) and its trailing text."""
    prompt = talker.build_voice_clone_prompt(talker_params, text_ids[0], speaker_embed, lang_id, icl_mode=False)
    return prompt, prompt.shape[1], talker.build_trailing_text(talker_params, text_ids, text_len), text_len


def voice_clone_xvector_impl(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,
    text_len: int,
    speaker_embed: torch.Tensor,  # [hidden]
    lang_id: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    graph: talker.PrefillGraph | None = None,
):
    with profiling.annotate("q3.prefill") as span:
        rows = voice_clone_xvector_rows(talker_params, text_ids, text_len, speaker_embed, lang_id)
        return _finish(talker_params, tcfg, scfg, rows, cache, uniforms, max_new_tokens, span, graph)


def voice_clone_icl_rows(talker_params: dict, all_text_ids: torch.Tensor, n_text: int, speaker_embed: torch.Tensor,
                         codec_rows: torch.Tensor, n_codec: int, lang_id: int, sequential: bool = False):
    """The 9 x-vector rows (no first-text row), then the ICL rows: overlaid
    (``n_codec`` true rows) or sequential (``n_text + n_codec``); returns
    (prompt, prefill_len, trailing, trailing_len)."""
    base = talker.build_voice_clone_prompt(talker_params, all_text_ids[0], speaker_embed, lang_id, icl_mode=True)
    build = talker.build_icl_rows_sequential if sequential else talker.build_icl_rows
    icl_rows, trailing, trailing_len = build(talker_params, all_text_ids, n_text, codec_rows, n_codec)
    icl_len = n_text + n_codec if sequential else n_codec
    return torch.cat([base, icl_rows], dim=1), base.shape[1] + icl_len, trailing, trailing_len


def voice_clone_icl_impl(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    all_text_ids: torch.Tensor,  # [Tb] ref + target + tts_eos
    n_text: int,
    speaker_embed: torch.Tensor,  # [hidden]
    codec_rows: torch.Tensor,  # [Cb, hidden] codec_bos + ref codec sums, padded
    n_codec: int,
    lang_id: int,
    cache: nn.KVCache,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    sequential: bool = False,
    graph: talker.PrefillGraph | None = None,
):
    """The 9 x-vector rows (no first-text row), then the ICL rows: overlaid
    (``n_codec`` true rows) or sequential (``n_text + n_codec``)."""
    with profiling.annotate("q3.prefill") as span:
        rows = voice_clone_icl_rows(talker_params, all_text_ids, n_text, speaker_embed, codec_rows, n_codec, lang_id,
                                    sequential)
        return _finish(talker_params, tcfg, scfg, rows, cache, uniforms, max_new_tokens, span, graph)


# The JAX package's names for its jitted programs; here the functions themselves.
prefill_custom_voice = custom_voice_impl
prefill_voice_design = voice_design_impl
prefill_voice_clone_xvector = voice_clone_xvector_impl
prefill_voice_clone_icl = voice_clone_icl_impl
