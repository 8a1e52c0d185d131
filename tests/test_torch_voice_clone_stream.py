"""ICL voice cloning streamed: the reference prefix of a stream, the port
against the JAX package and against itself (f32, CPU).

``tests/test_torch_voice_clone.py``'s tiny Base model and ICL prompt (16
reference frames) in both packages.

* ``synthesize_voice_clone_streaming`` pulled chunk by chunk (3 frames a
  chunk): the reference fed to the streaming vocoder first, in the JAX
  package's pieces (chunks, then a binary split of the rest: 3 x 5 + 1);
  the chunks give the JAX session's (lengths, audio within 1e-5), and put
  together ``synthesize_voice_clone``'s audio and the batch decode of
  [reference || frames] with the reference's samples cut, within 2e-6.
* A stream whose last chunk runs past the vocoder's KV cache (buckets cut to
  (4, 8, 16) frames, ``DECODE_BUCKET`` 4, an 8-frame reference: the cache
  holds 16 + 8 rows and the last chunk reaches row 26): the cache gets room
  and the stream still equals the whole synthesis.
* The chunk-local mode (``streaming_exact=False``): the first chunk decoded
  behind the reference, then cut; ``run_to_audio`` the prepend-and-
  proportional-cut; both the JAX package's within 1e-5.
* A fused talker whose cache leaves the whole-step kernel's gate
  (``TALKER_STREAM_MAX_SEQ``) when it grows: the steps after the growth take
  the layer path on the fused tree, and the frames equal the unfused
  model's.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.ops import fused_layer
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions, VoiceClonePrompt
from test_torch_voice_clone import TEXT, models, prompts  # noqa: F401  (module fixtures)

torch.set_num_threads(1)


def _samples(chunks) -> list:
    return [np.asarray(c.samples) for c in chunks]


def _batch_cut(model, prefix: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The batch decode of [prefix || frames], the prefix's samples cut."""
    return model.decode_codes(np.concatenate([prefix, frames])).samples[len(prefix) * SAMPLES_PER_FRAME:]


def _spy_pieces(monkeypatch) -> list:
    """The frame counts of every streaming-vocoder call of the port."""
    sizes, routed = [], tvoc.decode_stream_chunk

    def spy(params, cfg, state, codes):
        sizes.append(codes.shape[-1])
        return routed(params, cfg, state, codes)

    monkeypatch.setattr(tvoc, "decode_stream_chunk", spy)
    return sizes


def test_icl_stream_matches_jax_and_whole(models, prompts, monkeypatch):  # noqa: F811
    jm, tm = models
    kw = dict(max_length=10, seed=42, chunk_frames=3)
    want = _samples(jm.synthesize_voice_clone_streaming(TEXT, prompts[0], "english", JP.SynthesisOptions(**kw)))
    pieces = _spy_pieces(monkeypatch)
    session = tm.synthesize_voice_clone_streaming(TEXT, prompts[1], "english", SynthesisOptions(**kw))
    got = _samples(session)
    assert pieces == [3] * 5 + [1] + [3] * 4  # the prefix's pieces, then 4 chunks
    assert [len(c) // SAMPLES_PER_FRAME for c in got] == [len(c) // SAMPLES_PER_FRAME for c in want] == [3, 3, 3, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    stream = np.concatenate(got)
    assert np.abs(stream).max() > 1e-3
    whole = tm.synthesize_voice_clone(TEXT, prompts[1], "english", SynthesisOptions(**kw)).samples
    np.testing.assert_allclose(stream, whole, rtol=0, atol=2e-6)
    frames = session.state.frames[:session.frames_generated].numpy()
    np.testing.assert_allclose(stream, _batch_cut(tm, prompts[1].ref_codes, frames), rtol=0, atol=2e-6)


def test_icl_last_chunk_runs_past_vocoder_cache(models, monkeypatch):  # noqa: F811
    _, tm = models
    monkeypatch.setattr(TP, "FRAME_BUCKETS", (4, 8, 16))
    monkeypatch.setattr(TP, "GROWTH_INITIAL_FRAMES", 4)
    monkeypatch.setattr(TP, "DECODE_BUCKET", 4)
    rs = np.random.RandomState(8)
    prompt = VoiceClonePrompt(rs.randn(64).astype(np.float32), rs.randint(0, 128, (8, 16)).astype(np.int32), [7, 9])
    opts = SynthesisOptions(max_length=16, min_new_tokens=16, seed=3, chunk_frames=3)
    session = tm.synthesize_voice_clone_streaming(TEXT, prompt, "english", opts)
    first = session.next_chunk()
    # The second chunk (frames 4-6) is queued ahead of the first's return (streaming_lookahead 1): the
    # second tier's frames and the prefix's room.
    assert session.vstate.kv_k.shape[2] == 8 + 8
    stream = np.concatenate([first.samples] + _samples(session))
    assert session.frames_generated == 16
    # 8 reference rows + 15 frames emitted + a 3-row chunk: past 16 + 8 rows.
    assert session.vstate.kv_k.shape[2] == 8 + 15 + 3
    whole = tm.synthesize_voice_clone(TEXT, prompt, "english", opts).samples
    assert stream.shape == whole.shape == (16 * SAMPLES_PER_FRAME,)
    np.testing.assert_allclose(stream, whole, rtol=0, atol=2e-6)
    frames = session.state.frames[:16].numpy()
    np.testing.assert_allclose(stream, _batch_cut(tm, prompt.ref_codes, frames), rtol=0, atol=2e-6)


def test_icl_chunk_local_modes_match_jax(models, prompts):  # noqa: F811
    """``streaming_exact=False``: the chunks, then ``run_to_audio``'s
    prepend-and-proportional-cut, against the JAX package's."""
    jm, tm = models
    kw = dict(max_length=8, seed=42, chunk_frames=3, streaming_exact=False)
    want = _samples(jm.synthesize_voice_clone_streaming(TEXT, prompts[0], "english", JP.SynthesisOptions(**kw)))
    session = tm.synthesize_voice_clone_streaming(TEXT, prompts[1], "english", SynthesisOptions(**kw))
    got = _samples(session)
    assert session.vstate is None
    assert [len(c) // SAMPLES_PER_FRAME for c in got] == [len(c) // SAMPLES_PER_FRAME for c in want] == [3, 3, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert np.abs(got[0]).max() > 1e-3
    jwhole = jm.synthesize_voice_clone(TEXT, prompts[0], "english", JP.SynthesisOptions(**kw)).samples
    twhole = tm.synthesize_voice_clone(TEXT, prompts[1], "english", SynthesisOptions(**kw)).samples
    assert twhole.shape == jwhole.shape == (8 * SAMPLES_PER_FRAME,)
    np.testing.assert_allclose(twhole, jwhole, rtol=0, atol=1e-5)


def test_fused_talker_leaves_the_kernel_gate(models, prompts, monkeypatch):  # noqa: F811
    """An ICL prompt of 41 rows: the cache holds 64 rows at the first tier
    (4 frames), then 68 and 76. With the whole-step gate at 66 rows the
    first tier's steps run the whole-step path on the fused tree, the rest
    the layer path on the same fused tree; the frames equal the unfused
    model's (the layer path throughout)."""
    jm, tm = models
    fused = Qwen3TTS(tm.config, TW.fuse_model_params(tm.talker_params), tm.cp_params, tm.vocoder_params,
                     tm.tokenizer, vocoder_config=tm.vocoder_config)
    monkeypatch.setattr(TP, "FRAME_BUCKETS", (4, 8, 16))
    monkeypatch.setattr(TP, "GROWTH_INITIAL_FRAMES", 4)
    monkeypatch.setattr(fused_layer, "TALKER_STREAM_MAX_SEQ", 66)
    opts = SynthesisOptions(max_length=12, min_new_tokens=12, seed=9, temperature=0.0)
    session = fused._voice_clone_session(TEXT, prompts[1], "english", opts)
    modes = [ttalker.stream_plane_mode(fused.talker_params, fused.config.talker, session.state.cache)]
    steps = []
    routed = ttalker.decode_step

    def spy(*args, **kwargs):
        steps.append("layer" if not ttalker.stream_plane_mode(args[0], args[1], args[4]) else "whole-step")
        return routed(*args, **kwargs)

    monkeypatch.setattr(ttalker, "decode_step", spy)
    got = session.run_to_completion()
    modes.append(ttalker.stream_plane_mode(fused.talker_params, fused.config.talker, session.state.cache))
    assert session.state.cache.max_seq == 76 and modes == [True, False]
    assert steps == ["layer"] * 8  # frames 4..11 on the layer path; 0..3 on the plane views
    want = tm._voice_clone_session(TEXT, prompts[1], "english", replace(opts)).run_to_completion()
    assert got.shape == (12, 16)
    np.testing.assert_array_equal(got, want)
