"""Batched voice cloning, the port against the JAX package (f32, CPU).

``test_torch_batch.py``'s comparison (frames token-exact, audio within atol
1e-5 of the JAX package's ``synthesize_batch``, greedy and PCG) for the
cloning layouts: x-vector clones and preset speakers in one group (the
10-row layout with a per-stream speaker vector) and ICL clones, overlaid,
with reference prompts of different lengths (16 and 10 code frames) and
texts of different lengths, so that each stream prefills to its own length
and decodes at its own positions, under per-stream frame caps
(``ICL_MIN_FRAMES`` lowered in both packages so that the caps bind within
a short run). The models read text through ``WideTokenizer``, which keeps
up to 40 characters, so that texts and instructs differ in length.
"""

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio
from test_torch_batch import TEMPERATURES, check_batch, port_frames, voices
from test_torch_voice_clone import REF_TEXT, build_models, reference

torch.set_num_threads(1)

ICL_TEXTS = ["A", "Clone these words now."]  # 1 and 22 tokens
ICL_MIN_FRAMES = 4  # both packages' floor of the ICL cap, lowered: caps of 6 and 16 frames at max_length 16


class WideTokenizer:
    """Characters to small token ids, up to 40 of them."""

    def encode(self, text: str) -> list[int]:
        return [(3 + (ord(c) % 50)) for c in text[:40]] or [5]


def wide_models() -> tuple:
    jm, tm = build_models()
    jm.tokenizer = tm.tokenizer = WideTokenizer()
    return jm, tm


def icl_prompts(jm, tm) -> tuple[list, list]:
    """(JAX, port) ICL prompts: the 1.28 s reference's 16 code frames, and
    its first 10 frames with another reference text."""
    jp = jm.create_voice_clone_prompt(JAudio(reference(), 24000), REF_TEXT)
    tp = tm.create_voice_clone_prompt(TAudio(reference(), 24000), REF_TEXT)
    short_text = jm.tokenizer.encode("Short ref.")
    return ([jp, JP.VoiceClonePrompt(jp.speaker_embedding, jp.ref_codes[:10], short_text)],
            [tp, TP.VoiceClonePrompt(tp.speaker_embedding, tp.ref_codes[:10], short_text)])


@pytest.fixture(scope="module")
def models():
    return wide_models()


@pytest.fixture(scope="module")
def prompts(models):
    return icl_prompts(*models)


@pytest.fixture
def low_icl_floor(monkeypatch):
    monkeypatch.setattr(JP, "ICL_MIN_FRAMES", ICL_MIN_FRAMES)
    monkeypatch.setattr(TP, "ICL_MIN_FRAMES", ICL_MIN_FRAMES)


@TEMPERATURES
def test_xvector_and_preset_batch_matches_jax(models, prompts, temperature):
    """Two x-vector clones and a preset speaker share the 10-row layout:
    one group, one loop."""
    jm, tm = models
    spec = ["xvector", "ryan", "xvector"]
    texts = ["Hi", "A preset speaker here.", "Third clone text"]
    assert [k for k, _ in tm._split_batch_groups(voices(tm, spec, prompts[1][0]), [None] * 3)] == ["basic"]
    check_batch(jm, tm, texts, voices(jm, spec, prompts[0][0]), voices(tm, spec, prompts[1][0]), max_length=12,
                seed=42, temperature=temperature)


@TEMPERATURES
def test_icl_batch_matches_jax(models, prompts, low_icl_floor, temperature):
    """ICL clones overlaid: references of 16 and 10 frames, per-stream caps
    of 6 and 16 frames."""
    jm, tm = models
    frames, _ = check_batch(jm, tm, ICL_TEXTS, prompts[0], prompts[1], max_length=16, seed=42,
                            temperature=temperature)
    assert [len(f) for f in frames] == [6, 16]
    group = tm._prepare_batch_group("icl", ICL_TEXTS, prompts[1], ["english"] * 2, [None] * 2,
                                    TP.SynthesisOptions(max_length=16, seed=42), [42, 43])
    assert group.state.pos.tolist() == [9 + 16 + 1, 9 + 10 + 1] and group.frame_limits == [6, 16]
    assert group.scfg.repetition_penalty == 1.5


def test_icl_batch_streams_equal_solo_runs(models, prompts, low_icl_floor):
    """Each ICL stream of the batch against the port's batch-1 clone of it:
    frames, and the audio of ``synthesize_voice_clone_debug`` (the staged
    clone: [reference || frames] decoded, the reference's samples cut)."""
    _, tm = models
    opts = TP.SynthesisOptions(max_length=16, seed=42)
    frames = port_frames(tm, ICL_TEXTS, prompts[1], "english", opts, None, None)
    audio = tm.synthesize_batch(ICL_TEXTS, prompts[1], options=opts)
    for i, (text, prompt) in enumerate(zip(ICL_TEXTS, prompts[1])):
        solo, solo_frames = tm.synthesize_voice_clone_debug(text, prompt, "english", TP.SynthesisOptions(
            max_length=16, seed=42 + i))
        assert len(solo_frames) == (6, 16)[i]
        np.testing.assert_array_equal(frames[i], solo_frames)
        np.testing.assert_allclose(audio[i].samples, solo.samples, rtol=0, atol=1e-5)
