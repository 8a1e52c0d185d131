"""Batched (throughput-mode) generation: many utterances, one loop.

PyTorch port of ``qwen3_tts_tpu/generation/batch.py``: the same five entry
points, names and argument order. A prefill takes B streams' inputs padded
to one bucket (``[B, Tb]`` ids with ``[B]`` true lengths, as tensors or
lists), builds each stream's prompt rows with ``prefill.py``'s ``*_rows``
builders and prefills them together (``prefill.finish_batch``: one prompt
right-padded to the shared bucket, stream b's prefill ending at its own
length); it returns the ``core.BatchGenState`` of the B streams, the
trailing text ``[B, Tb, hidden]``, the trailing lengths and the pad row
``[hidden]``. ``generate_frames_batch`` runs the batched frame loop on that
state (``core.generate_frames_replicas`` with one replica). The JAX package
``vmap``s each batch-1 program over the streams; here the B rows go through
one eager layer path, whose every projection multiplies them with one
weight read. The lengths are host integers (the rows' slices and the loop's
indices are host-side), so a tensor of them is read once on entry.

``caches`` is the ``nn.KVCache`` of the B streams, ``[L, B, S, KV, D]``
(the JAX package's is ``[B, L, 1, S, KV, D]``). Under a ``mesh``
(``Qwen3TTS.shard``) a call takes one dp replica's share: its talker is the
replica's ``parallel.sharding.ShardedTree``, ``caches`` an ``nn.TPCache``,
the other inputs on the replica's first device; the dp split of a batch and
its replicas in lock-step are ``Qwen3TTS._prepare_batch_group`` and
``core.generate_frames_replicas``. ``w8a8`` runs the call inside
``quant.w8a8_scope``.

The JAX package's ``_batch_pallas_dequant`` chose, per batched program,
between its Pallas dequant matmul and XLA's cast-fused dequant dot: the
dot by default, because it measured equal or better at every batch size on
the TPU and is the only form GSPMD can partition over tp-sharded weights;
the Pallas kernel only behind the ``QWEN3_TTS_BATCH_PALLAS_DEQUANT=1``
opt-in, unsharded. The port has one int8 route: kernel 4
(``csrc/int8_matmul.cu``), whose batch rule folds the B streams into its
rows (``quant.int8_matmul_route``), on every replica's own device; so there
is no switch to make, and no opt-in.
"""

from __future__ import annotations

import torch

from ..models.config import CodePredictorConfig, TalkerConfig
from ..ops import quant, sampling
from ..parallel import collectives
from . import core, prefill


def _ints(values) -> list[int]:
    """Host integers from a ``[B]`` tensor (one read) or a sequence."""
    return values.tolist() if isinstance(values, torch.Tensor) else [int(v) for v in values]


def _finish(talker_params, tcfg: TalkerConfig, scfg: sampling.SamplingConfig, build, caches, uniforms: torch.Tensor,
            max_new_tokens: int, mesh, w8a8: bool):
    """Build every stream's rows (``build()``) and prefill them together,
    on the device of ``uniforms`` (a replica's first under a mesh)."""
    core._check_mesh(talker_params, mesh)
    with quant.w8a8_scope(w8a8), collectives.device_scope(uniforms.device):
        return prefill.finish_batch(talker_params, tcfg, scfg, build(), caches, uniforms, max_new_tokens)


def prefill_custom_voice_batch(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,  # [B, Tb]
    text_lens,  # [B]
    speaker_ids,  # [B] codec speaker tokens
    lang_ids,  # [B] codec language tokens
    caches,  # nn.KVCache [L, B, S, KV, D] (a replica's nn.TPCache under a mesh)
    uniforms: torch.Tensor,  # [B, max_new + 1]
    max_new_tokens: int,
    mesh=None,
    w8a8: bool = False,
):
    """Returns (``core.BatchGenState``, trailing [B, Tb, hidden],
    trailing_lens, pad [hidden])."""
    lens, speakers, langs = _ints(text_lens), _ints(speaker_ids), _ints(lang_ids)
    return _finish(talker_params, tcfg, scfg, lambda: [
        prefill.custom_voice_rows(talker_params, text_ids[i], n, s, lang) for i, (n, s, lang) in
        enumerate(zip(lens, speakers, langs))], caches, uniforms, max_new_tokens, mesh, w8a8)


def prefill_voice_clone_batch(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,  # [B, Tb]
    text_lens,  # [B]
    speaker_vecs: torch.Tensor,  # [B, hidden] x-vectors / speaker-token embeds
    lang_ids,  # [B]
    caches,
    uniforms: torch.Tensor,  # [B, max_new + 1]
    max_new_tokens: int,
    mesh=None,
    w8a8: bool = False,
):
    """Batched x-vector clone prefill (the 10-row layout, a vector a
    stream; a preset speaker's vector is its speaker-token embedding, which
    gives its CustomVoice rows bit for bit)."""
    lens, langs = _ints(text_lens), _ints(lang_ids)
    return _finish(talker_params, tcfg, scfg, lambda: [
        prefill.voice_clone_xvector_rows(talker_params, text_ids[i], n, speaker_vecs[i], lang) for i, (n, lang) in
        enumerate(zip(lens, langs))], caches, uniforms, max_new_tokens, mesh, w8a8)


def prefill_voice_design_batch(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    text_ids: torch.Tensor,  # [B, Tb]
    text_lens,  # [B]
    instruct_ids: torch.Tensor,  # [B, Ib] right-padded ChatML instruct tokens
    instruct_lens,  # [B]
    lang_ids,  # [B]
    caches,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    mesh=None,
    w8a8: bool = False,
):
    """Batched voice-design prefill (the [Ib + 9]-row layout, each stream's
    instruct right-padded to the shared bucket)."""
    lens, ins, langs = _ints(text_lens), _ints(instruct_lens), _ints(lang_ids)
    return _finish(talker_params, tcfg, scfg, lambda: [
        prefill.voice_design_rows(talker_params, text_ids[i], n, instruct_ids[i], m, lang) for i, (n, m, lang) in
        enumerate(zip(lens, ins, langs))], caches, uniforms, max_new_tokens, mesh, w8a8)


def prefill_voice_clone_icl_batch(
    talker_params: dict,
    tcfg: TalkerConfig,
    scfg: sampling.SamplingConfig,
    all_text_ids: torch.Tensor,  # [B, Tb] ref + target + tts_eos, padded
    n_texts,  # [B]
    speaker_vecs: torch.Tensor,  # [B, hidden]
    codec_rows: torch.Tensor,  # [B, Cb, hidden] codec_bos + ref sums, padded
    n_codecs,  # [B]
    lang_ids,  # [B]
    caches,
    uniforms: torch.Tensor,
    max_new_tokens: int,
    sequential: bool = False,
    mesh=None,
    w8a8: bool = False,
):
    """Batched ICL-clone prefill: each stream's reference-code rows at a
    shared bucket, its true lengths in ``n_texts`` / ``n_codecs``; overlaid,
    or ``sequential``."""
    nt, nc, langs = _ints(n_texts), _ints(n_codecs), _ints(lang_ids)
    return _finish(talker_params, tcfg, scfg, lambda: [
        prefill.voice_clone_icl_rows(talker_params, all_text_ids[i], n, speaker_vecs[i], codec_rows[i], c, lang,
                                     sequential) for i, (n, c, lang) in enumerate(zip(nt, nc, langs))],
        caches, uniforms, max_new_tokens, mesh, w8a8)


def generate_frames_batch(
    talker_params: dict,
    cp_params: dict,
    tcfg: TalkerConfig,
    cpcfg: CodePredictorConfig,
    scfg: sampling.SamplingConfig,
    states: core.BatchGenState,
    trailing: torch.Tensor,  # [B, Tb, H]
    trailing_lens,  # [B]
    pad_embed: torch.Tensor,  # [H] (shared)
    uniforms: torch.Tensor,  # [B, max_new + 1]
    frame_limit,  # [B] per-stream frame budgets
    mesh=None,
    w8a8: bool = False,
) -> core.BatchGenState:
    """Run the batched frame loop on ``states`` until every stream is done
    or at its limit (``core.generate_frames_batch``; tiered decode
    attention off, as the JAX package forces it under ``vmap``)."""
    with quant.w8a8_scope(w8a8):
        return core.generate_frames_batch(talker_params, cp_params, tcfg, cpcfg, scfg, states, trailing,
                                          _ints(trailing_lens), pad_embed, uniforms, _ints(frame_limit), mesh)
