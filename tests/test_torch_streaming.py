"""The port's streaming synthesis against the JAX package's (f32, CPU).

``tests/test_pipeline.tiny_model()``'s configuration and seed (its weights
drawn under ``jax.jit``) goes to numpy and into the port
(``Qwen3TTS.from_numpy``), as in ``tests/test_torch_pipeline.py``. With the
same seed and options:

* ``synthesize_streaming`` pulled chunk by chunk gives the JAX session's
  chunks: the same lengths (a 4-frame first chunk), token-exact frames,
  audio within atol 1e-5; and the port's staged decode of its frames within
  atol 2e-6 (the JAX package's bar for the same pair);
* buffers grown tier by tier (``FRAME_BUCKETS`` = (4, 8, 16),
  ``GROWTH_INITIAL_FRAMES`` = 4) give the frames of a full-size session and
  of the JAX package's grown session, token for token, on the layer path
  and on the whole-step path (a fused f32 talker);
* ``streaming_lookahead`` 0, 1 and 2 give the same chunks;
* the legacy mode (``streaming_exact=False``) gives the JAX package's chunks;
* ``synthesize_with_voice`` (``run_to_audio``) gives the JAX package's audio;
* a session stopped by EOS mid-chunk: the same chunks as the JAX session,
  and nothing more after it;
* ``max_length`` is clamped, the buffers start at the growth tier, and the
  cache holds 160 rows for 125 frames and 288 at the default length.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
import qwen3_tts_tpu_torch.pipeline as TP
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.codec import vocoder as jvoc
from qwen3_tts_tpu.models.config import ModelConfig as JModelConfig
from qwen3_tts_tpu.models.config import ModelType
from qwen3_tts_tpu.pipeline import SynthesisOptions as JOptions
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, TalkerConfig, config_for_variant
from qwen3_tts_tpu_torch.models.tokens import SAMPLES_PER_FRAME
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_pipeline import TINY_CP, TINY_TALKER, TINY_VOC, FakeTokenizer

torch.set_num_threads(1)

TEXT = "Stream this text."


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tiny_model() -> JP.Qwen3TTS:
    """``tiny_model()``, its weights drawn under ``jax.jit`` (faster)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    cfg = JModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="0b6", talker=TINY_TALKER,
                       code_predictor=TINY_CP)
    return JP.Qwen3TTS(
        cfg,
        jax.jit(JW.init_talker_params, static_argnums=(1, 2))(k1, TINY_TALKER, jnp.float32),
        jax.jit(JW.init_code_predictor_params, static_argnums=(1, 2))(k2, TINY_CP, jnp.float32),
        jax.jit(jvoc.init_vocoder_params, static_argnums=1)(k3, TINY_VOC),
        FakeTokenizer(),
        vocoder_config=TINY_VOC,
    )


def _port_model(jm: JP.Qwen3TTS, talker_tree: dict) -> Qwen3TTS:
    cfg = replace(
        config_for_variant("0.6B", "custom_voice"),
        talker=TalkerConfig(**asdict(jm.config.talker)),
        code_predictor=CodePredictorConfig(**asdict(jm.config.code_predictor)),
    )
    return Qwen3TTS.from_numpy(
        cfg, _numpy(talker_tree), _numpy(jm.cp_params), _numpy(jm.vocoder_params),
        FakeTokenizer(), vocoder_config=tvoc.VocoderConfig(**asdict(TINY_VOC)), device="cpu",
    )


@pytest.fixture(scope="module")
def models():
    jm = _jax_tiny_model()
    return jm, _port_model(jm, jm.talker_params)


def _both(**kw):
    return JOptions(**kw), SynthesisOptions(**kw)


def _samples(chunks) -> list[np.ndarray]:
    return [np.asarray(c.samples) for c in chunks]


def _assert_chunks_equal(got: list, want: list, atol: float = 1e-5) -> None:
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _small_buckets(monkeypatch, decode_bucket: int | None = None) -> None:
    """Both packages' tiers cut to (4, 8, 16) frames, growth from 4."""
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "FRAME_BUCKETS", (4, 8, 16))
        monkeypatch.setattr(mod, "GROWTH_INITIAL_FRAMES", 4)
        if decode_bucket is not None:
            monkeypatch.setattr(mod, "DECODE_BUCKET", decode_bucket)


def test_streaming_chunks_match_jax(models):
    jm, tm = models
    jopts, topts = _both(max_length=20, seed=42)
    js = jm.synthesize_streaming(TEXT, "ryan", "english", jopts)
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", topts)
    want, got = _samples(js), _samples(ts)
    assert [len(c) // SAMPLES_PER_FRAME for c in got] == [4, 10, 6]
    _assert_chunks_equal(got, want)
    assert ts.next_chunk() is None and ts.is_done()
    n = ts.frames_generated
    assert n == int(js.state.frame_idx) == 20
    np.testing.assert_array_equal(ts.state.frames[:n].numpy(), np.asarray(js.state.frames)[:n])

    # The chunks put together are the staged decode of the same frames.
    frames = tm._custom_voice_session(TEXT, "ryan", "english", topts).run_to_completion()
    np.testing.assert_array_equal(frames, ts.state.frames[:n].numpy())
    staged = tm.decode_codes(frames).samples
    np.testing.assert_allclose(np.concatenate(got), staged, rtol=0, atol=2e-6)


@pytest.mark.parametrize("path", ["layer", "whole-step"])
def test_growth_is_token_exact(models, monkeypatch, path):
    """10 frames through tiers 4 -> 8 -> 16: the grown session's frames equal
    a full-size session's (the growth tier above the bucket) and the JAX
    package's grown session's; its streamed chunks cross two growths and
    still give the staged decode's audio. The whole-step path: the same
    talker handed to the port fused (its steps on the cache's plane views,
    taken anew after each growth)."""
    jm, tm = models
    if path == "whole-step":
        tm = _port_model(jm, JW.fuse_model_params(jm.talker_params))
    jopts, topts = _both(max_length=10, seed=11, chunk_frames=3)
    _small_buckets(monkeypatch)
    grown = tm.synthesize_streaming(TEXT, "ryan", "english", topts)
    assert grown.state.frames.shape[0] == 4 and grown.state.cache.max_seq == 32
    assert ttalker.stream_plane_mode(tm.talker_params, tm.config.talker, grown.state.cache) == (path == "whole-step")
    frames = grown.run_to_completion()
    assert grown.state.frames.shape[0] == 16 and grown.state.cache.max_seq == 32 + 12
    want = jm._custom_voice_session(TEXT, "ryan", "english", jopts).run_to_completion()
    np.testing.assert_array_equal(frames, want)

    monkeypatch.setattr(TP, "GROWTH_INITIAL_FRAMES", 4096)
    full = tm.synthesize_streaming(TEXT, "ryan", "english", topts)
    assert full.state.frames.shape[0] == 16
    np.testing.assert_array_equal(full.run_to_completion(), frames)

    monkeypatch.setattr(TP, "GROWTH_INITIAL_FRAMES", 4)
    chunks = _samples(tm.synthesize_streaming(TEXT, "ryan", "english", topts))
    assert [len(c) // SAMPLES_PER_FRAME for c in chunks] == [3, 3, 3, 1]
    np.testing.assert_allclose(np.concatenate(chunks), tm.decode_codes(frames).samples, rtol=0, atol=2e-6)


def test_streaming_lookahead_gives_the_same_chunks(models):
    _, tm = models
    base = dict(max_length=9, seed=5, chunk_frames=2, first_chunk_frames=None)
    runs = [_samples(tm.synthesize_streaming(TEXT, "ryan", "english", SynthesisOptions(streaming_lookahead=k, **base)))
            for k in (0, 1, 2)]
    assert [len(c) // SAMPLES_PER_FRAME for c in runs[0]] == [2, 2, 2, 2, 1]
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


def test_legacy_streaming_matches_jax(models):
    jm, tm = models
    jopts, topts = _both(max_length=12, seed=42, chunk_frames=3, streaming_exact=False)
    js = jm.synthesize_streaming(TEXT, "ryan", "english", jopts)
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", topts)
    got, want = _samples(ts), _samples(js)
    assert ts.vstate is None and js.vstate is None
    assert [len(c) // SAMPLES_PER_FRAME for c in got] == [3, 3, 3, 3]
    _assert_chunks_equal(got, want)


def test_run_to_audio_matches_jax(models, monkeypatch):
    """``synthesize_with_voice`` in chunks of 4 frames across two growths:
    the JAX package's audio within 1e-5, the staged decode's within 2e-6."""
    jm, tm = models
    jopts, topts = _both(max_length=10, seed=11)
    _small_buckets(monkeypatch, decode_bucket=4)
    got = tm.synthesize_with_voice(TEXT, "ryan", "english", topts).samples
    want = jm.synthesize_with_voice(TEXT, "ryan", "english", jopts).samples
    assert got.shape == want.shape == (10 * SAMPLES_PER_FRAME,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    frames = tm._custom_voice_session(TEXT, "ryan", "english", topts).run_to_completion()
    np.testing.assert_allclose(got, tm.decode_codes(frames).samples, rtol=0, atol=2e-6)


def test_next_chunk_then_run_to_audio(models):
    """A chunk pulled, then the rest as one buffer: the utterance once."""
    _, tm = models
    opts = SynthesisOptions(max_length=8, seed=42, chunk_frames=3)
    session = tm.synthesize_streaming(TEXT, "ryan", "english", opts)
    first = session.next_chunk()
    rest = session.run_to_audio()
    frames = tm._custom_voice_session(TEXT, "ryan", "english", opts).run_to_completion()
    stream = np.concatenate([first.samples, rest.samples])
    np.testing.assert_allclose(stream, tm.decode_codes(frames).samples, rtol=0, atol=2e-6)


def test_eos_mid_chunk_matches_jax(models):
    """A session that meets EOS inside a chunk: the JAX session's chunks and
    frames, the last chunk cut at EOS, then nothing more; the loop does not
    move past EOS when entered again."""
    jm, tm = models
    probe = tm._custom_voice_session(TEXT, "ryan", "english", SynthesisOptions(max_length=20, seed=42))
    tokens = probe.run_to_completion()[:, 0]
    # The first token that appears only from frame 7 on: EOS there.
    eos = next(int(t) for i, t in enumerate(tokens) if i >= 7 and t not in tokens[:i])
    jopts, topts = _both(max_length=20, seed=42, eos_token_id=eos)
    js = jm.synthesize_streaming(TEXT, "ryan", "english", jopts)
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", topts)
    got, want = _samples(ts), _samples(js)
    _assert_chunks_equal(got, want)
    n = ts.frames_generated
    assert n < 14 and sum(len(c) for c in got) == n * SAMPLES_PER_FRAME
    assert ts.next_chunk() is None
    ts._advance(20)
    assert ts.frames_generated == n
    np.testing.assert_array_equal(ts.state.frames[:n].numpy(), np.asarray(js.state.frames)[:n])


def test_frame_limit_capped_at_buffer(models):
    _, tm = models
    session = tm.synthesize_streaming(TEXT, "ryan", "english", SynthesisOptions(max_length=8, seed=1))
    session._advance(10_000)
    assert session.frames_generated <= session.state.frames.shape[0]


def test_max_length_clamp_and_initial_tier(models):
    _, tm = models
    session = tm.synthesize_streaming(TEXT, "ryan", "english", SynthesisOptions(max_length=TP.FRAME_BUCKETS[-1] + 1000))
    assert session.options.max_length == TP.FRAME_BUCKETS[-1]
    assert session.state.frames.shape[0] == TP.GROWTH_INITIAL_FRAMES
    assert session.state.cache.max_seq == 288  # 10 prompt rows + 256 frames + 8, to a multiple of 16
    assert tm.synthesize_streaming(TEXT, options=SynthesisOptions(max_length=125)).state.cache.max_seq == 160
    with pytest.raises(ValueError):
        tm.synthesize_streaming(TEXT, options=SynthesisOptions(max_length=0))
