"""Voice cloning and voice design, the port against the JAX package (f32, CPU).

A tiny Base model (``tests/test_pipeline.py``'s talker and code predictor,
drawn from one seed under ``jax.jit``; the tiny vocoder's weights from
``vocoder_fixture.numpy_params``, so the audio has a real scale) with a
speaker encoder and a Mimi encoder at small widths (``encoder_fixture``'s
seeded numpy trees) goes to both packages (``Qwen3TTS.from_numpy`` with
``speaker_tree`` / ``mimi_tree``). With the same reference audio, text and
options:

* each prompt builder gives the JAX package's rows within 1e-6;
* ``create_voice_clone_prompt`` gives its x-vector within 1e-5 of max|x|
  and its ICL codes and text ids equal, from 24 kHz and from 16 kHz audio;
* x-vector sessions (here), ICL sessions, overlaid and sequential
  (``test_torch_voice_clone_icl.py``) and voice-design sessions
  (``test_torch_voice_design.py``), greedy and under seeded
  PCG sampling, give token-exact frames and, through
  ``run_to_audio`` (``synthesize_voice_clone`` / ``synthesize_voice_design``:
  the ICL reference fed to the streaming vocoder first), audio within atol
  1e-5 and 1e-4 of max|audio|; the ICL overrides (repetition penalty, length
  clamp) are the JAX package's.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.audio.io import AudioBuffer as JAudio
from qwen3_tts_tpu.models import speaker as jspeaker
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.codec import encoder as jencoder
from qwen3_tts_tpu.models.config import ModelConfig as JModelConfig
from qwen3_tts_tpu.models.config import ModelType
from qwen3_tts_tpu.models.config import SpeakerEncoderConfig as JSpeakerConfig
from qwen3_tts_tpu_torch import encoder_fixture, vocoder_fixture
from qwen3_tts_tpu_torch.audio.io import AudioBuffer as TAudio
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models.codec import encoder as tencoder
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, SpeakerEncoderConfig, TalkerConfig
from qwen3_tts_tpu_torch.models.config import config_for_variant
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions, VoiceClonePrompt
from test_pipeline import TINY_CP, TINY_TALKER, TINY_VOC, FakeTokenizer

torch.set_num_threads(1)

TEXT = "Clone this text."
REF_TEXT = "Reference words."
INSTRUCT = "a calm, low voice"
SPEAKER = dict(enc_dim=TINY_TALKER.hidden_size, enc_channels=(32, 32, 32, 32, 96), enc_attention_channels=16,
               enc_se_channels=16, enc_res2net_scale=4)
# Codebooks of the code predictor's vocabulary: ICL codes index its embeddings.
MIMI = dict(num_filters=8, hidden_size=32, num_layers=2, num_heads=2, head_dim=16, intermediate_size=64,
            codebook_size=TINY_CP.vocab_size, codebook_dim=16)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def build_models(model_type: ModelType = ModelType.BASE) -> tuple:
    """The JAX model and its port (CPU), both with the encoders."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3), 2)
    speaker_tree = encoder_fixture.speaker_numpy_params(SpeakerEncoderConfig(**SPEAKER), seed=11)
    mimi_tree = encoder_fixture.mimi_numpy_params(tencoder.MimiEncoderConfig(**MIMI), seed=12)
    vocoder_tree = vocoder_fixture.numpy_params(tvoc.VocoderConfig(**asdict(TINY_VOC)), seed=13)
    jcfg = JModelConfig(model_type=model_type, model_size="0b6", talker=TINY_TALKER, code_predictor=TINY_CP,
                        speaker_encoder=JSpeakerConfig(**SPEAKER))
    jm = JP.Qwen3TTS(
        jcfg,
        jax.jit(JW.init_talker_params, static_argnums=(1, 2))(k1, TINY_TALKER, jnp.float32),
        jax.jit(JW.init_code_predictor_params, static_argnums=(1, 2))(k2, TINY_CP, jnp.float32),
        jax.tree.map(jnp.asarray, vocoder_tree),
        FakeTokenizer(),
        jspeaker.SpeakerEncoder(jax.tree.map(jnp.asarray, speaker_tree), JSpeakerConfig(**SPEAKER)),
        jencoder.Encoder12Hz(jax.tree.map(jnp.asarray, mimi_tree), jencoder.MimiEncoderConfig(**MIMI)),
        vocoder_config=TINY_VOC,
    )
    tcfg = replace(
        config_for_variant("0.6B", "base"), model_type=model_type,
        talker=TalkerConfig(**asdict(TINY_TALKER)), code_predictor=CodePredictorConfig(**asdict(TINY_CP)),
        speaker_encoder=SpeakerEncoderConfig(**SPEAKER),
    )
    tm = Qwen3TTS.from_numpy(
        tcfg, _numpy(jm.talker_params), _numpy(jm.cp_params), vocoder_tree, FakeTokenizer(),
        vocoder_config=tvoc.VocoderConfig(**asdict(TINY_VOC)), device="cpu", speaker_tree=speaker_tree,
        mimi_tree=mimi_tree, mimi_config=tencoder.MimiEncoderConfig(**MIMI),
    )
    return jm, tm


def reference(rate: int = 24000) -> np.ndarray:
    """1.28 s of reference audio: 16 frames of codes (one 16-frame piece for
    the streaming vocoder, so the JAX package compiles one program for it)."""
    return encoder_fixture.reference_audio(rate, seed=5, seconds=1.28)


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def prompts(models):
    """(JAX, port) ICL prompts from the same 1.28 s reference at 24 kHz."""
    jm, tm = models
    return (jm.create_voice_clone_prompt(JAudio(reference(), 24000), REF_TEXT),
            tm.create_voice_clone_prompt(TAudio(reference(), 24000), REF_TEXT))


def _close(got, want, atol: float = 1e-6) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_prompt_builders_match_jax(models):
    jm, tm = models
    jp, tp = jm.talker_params, tm.talker_params
    rs = np.random.RandomState(0)
    spk = rs.randn(TINY_TALKER.hidden_size).astype(np.float32)
    ids = np.array([7, 9, 11, 13, 2150, 0, 0, 0], np.int32)  # ref + target text + tts_eos, padded
    codec = rs.randn(8, TINY_TALKER.hidden_size).astype(np.float32)
    for icl in (False, True):
        _close(ttalker.build_voice_clone_prompt(tp, torch.tensor(ids[0]), torch.from_numpy(spk), 2050, icl),
               jtalker.build_voice_clone_prompt(jp, jnp.asarray(ids[0]), jnp.asarray(spk), 2050, icl))
    _close(ttalker.build_voice_design_suffix(tp, torch.tensor(ids[0]), 2055),
           jtalker.build_voice_design_suffix(jp, jnp.asarray(ids[0]), 2055))
    for n_text, n_codec in ((5, 3), (5, 7), (2, 2)):
        for name in ("build_icl_rows", "build_icl_rows_sequential"):
            got = getattr(ttalker, name)(tp, torch.from_numpy(ids.astype(np.int64)), n_text,
                                         torch.from_numpy(codec), n_codec)
            want = getattr(jtalker, name)(jp, jnp.asarray(ids), jnp.int32(n_text), jnp.asarray(codec),
                                          jnp.int32(n_codec))
            _close(got[0], want[0])
            _close(got[1], want[1])
            assert got[2] == int(want[2])


@pytest.mark.parametrize("rate", [24000, 16000])
def test_create_voice_clone_prompt_matches_jax(models, rate):
    """From 24 kHz and from 16 kHz audio (resampled first): the x-vector
    within 1e-5 of max|x|, the codes and text ids equal; without the text,
    the x-vector alone."""
    jm, tm = models
    jp = jm.create_voice_clone_prompt(JAudio(reference(rate), rate), REF_TEXT)
    tp = tm.create_voice_clone_prompt(TAudio(reference(rate), rate), REF_TEXT)
    assert tp.speaker_embedding.shape == (TINY_TALKER.hidden_size,)
    _close(tp.speaker_embedding, jp.speaker_embedding, 1e-5 * np.abs(jp.speaker_embedding).max())
    assert tp.ref_codes.dtype == np.int32 and tp.ref_codes.shape == (16, 16)
    np.testing.assert_array_equal(tp.ref_codes, jp.ref_codes)
    assert tp.ref_text_ids == jp.ref_text_ids == FakeTokenizer().encode(REF_TEXT)
    xv = tm.create_voice_clone_prompt(TAudio(reference(rate), rate))
    assert xv.ref_codes is None and xv.ref_text_ids is None
    np.testing.assert_array_equal(xv.speaker_embedding, tp.speaker_embedding)


def test_capabilities_and_refusals(models):
    _, tm = models
    assert tm.supports_voice_cloning() and tm.has_speech_encoder()
    assert not tm.supports_preset_speakers() and not tm.supports_voice_design()
    no_speech = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                         tm.speaker_encoder, vocoder_config=tm.vocoder_config)
    assert no_speech.supports_voice_cloning() and not no_speech.has_speech_encoder()
    with pytest.raises(RuntimeError, match="speech encoder"):
        no_speech.create_voice_clone_prompt(TAudio(reference(), 24000), REF_TEXT)
    design = Qwen3TTS(replace(tm.config, model_type=ModelType.VOICE_DESIGN), tm.talker_params, tm.cp_params,
                      tm.vocoder_params, tm.tokenizer, vocoder_config=tm.vocoder_config)
    assert design.supports_voice_design() and not design.supports_voice_cloning()
    with pytest.raises(RuntimeError, match="text-described voices"):
        design.create_voice_clone_prompt(TAudio(reference(), 24000))


def _session(model, kind: str, prompt, options):
    """A session of ``kind`` with its ICL prefix set, as
    ``synthesize_voice_clone`` / ``synthesize_voice_design`` build it."""
    if kind == "design":
        return model._voice_design_session(TEXT, INSTRUCT, "english", options)
    if kind == "xvector":
        prompt = type(prompt)(prompt.speaker_embedding)
    if isinstance(model, Qwen3TTS):  # the port sets the prefix itself
        return model._voice_clone_session(TEXT, prompt, "english", options)
    session, ref_len = model._voice_clone_session(TEXT, prompt, "english", options)
    if ref_len:
        session.prefix_codes = np.asarray(prompt.ref_codes, np.int32)
    return session


def check_session(models, prompts, kind: str, temperature: float) -> None:
    """Token-exact frames and the audio within atol 1e-5 (and 1e-4 of
    max|audio|) of the JAX session's, through ``run_to_audio``; the public
    entry point gives the same audio as the session."""
    jm, tm = models
    kw = dict(max_length=10, seed=42, temperature=temperature, icl_sequential=kind == "icl_sequential")
    jsession = _session(jm, kind, prompts[0], JP.SynthesisOptions(**kw))
    tsession = _session(tm, kind, prompts[1], SynthesisOptions(**kw))
    assert asdict(tsession.options) == asdict(jsession.options)
    if kind.startswith("icl"):
        assert tsession.options.repetition_penalty == 1.5 and len(tsession.prefix_codes) == 16
    want = jsession.run_to_audio().samples
    got = tsession.run_to_audio().samples
    n = tsession.frames_emitted
    assert n == jsession.frames_emitted and n > 0
    np.testing.assert_array_equal(tsession.state.frames[:n].numpy(), np.asarray(jsession.state.frames)[:n])
    assert got.shape == want.shape == (n * SAMPLES_PER_FRAME,)
    _close(got, want, 1e-5)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() and np.abs(want).max() > 1e-3

    opts = SynthesisOptions(**kw)
    if kind == "design":
        public = tm.synthesize_voice_design(TEXT, INSTRUCT, "english", opts)
    else:
        prompt = prompts[1] if kind.startswith("icl") else VoiceClonePrompt(prompts[1].speaker_embedding)
        public = tm.synthesize_voice_clone(TEXT, prompt, "english", opts)
    np.testing.assert_array_equal(public.samples, got)


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])
def test_xvector_sessions_match_jax(models, prompts, temperature):
    check_session(models, prompts, "xvector", temperature)


def test_icl_overrides_match_jax(models, prompts):
    """The ICL overrides before the uniforms are drawn: repetition penalty
    raised to 1.5, max_length clamped to max(75, 6 x text tokens); a larger
    penalty and a shorter length are kept."""
    jm, tm = models
    for kw in (dict(max_length=2048, repetition_penalty=1.05), dict(max_length=30, repetition_penalty=1.7)):
        jsession = _session(jm, "icl", prompts[0], JP.SynthesisOptions(seed=1, **kw))
        tsession = _session(tm, "icl", prompts[1], SynthesisOptions(seed=1, **kw))
        assert asdict(tsession.options) == asdict(jsession.options)
        assert tsession.uniforms.shape == jsession.uniforms.shape
        np.testing.assert_array_equal(tsession.uniforms.numpy(), np.asarray(jsession.uniforms))
        assert tsession.state.pos == int(jsession.state.pos) == 9 + 16 + 1  # x-vector rows, codec_bos + reference
    assert tsession.options.max_length == 30 and tsession.options.repetition_penalty == 1.7
    assert _session(tm, "icl", prompts[1], SynthesisOptions()).options.max_length == 75
