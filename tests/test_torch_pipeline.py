"""The port's main path against the JAX package's, end to end (f32, CPU).

``tests/test_pipeline.tiny_model()`` goes to numpy and into the port
(``Qwen3TTS.from_numpy``). With ``seed=42, temperature=0.9`` the frames must
be token-exact and the audio within atol 1e-5; ``synthesize_with_voice``
(the streaming vocoder) must give ``synthesize_with_timing``'s audio within
atol 2e-6 and the JAX package's within 1e-5. The one-frame step
that ``__graft_entry__.entry()`` builds is compared the same way at the
tiny size. A model built on the CPU keeps its talker unfused (the layer
path); handed a fused f32 talker, its decode steps take the whole-step
path, and its frames must equal those of the JAX model with the plain
stream pack (``QWEN3_TTS_BF16_STREAM_PACK=1``), audio within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import sampling as jsampling
from qwen3_tts_tpu.pipeline import SynthesisOptions as JOptions
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from qwen3_tts_tpu_torch.models.config import config_for_variant
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import sampling as tsampling
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_pipeline import TINY_VOC, FakeTokenizer, tiny_model

torch.set_num_threads(1)

TEXT = "Hello there, general."


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jm = tiny_model()
    # The port's own dataclasses, built from the JAX model's config values.
    tcfg = config_for_variant("0.6B", "custom_voice")
    from dataclasses import asdict, replace

    from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, TalkerConfig

    tcfg = replace(
        tcfg,
        talker=TalkerConfig(**asdict(jm.config.talker)),
        code_predictor=CodePredictorConfig(**asdict(jm.config.code_predictor)),
    )
    vcfg = tvoc.VocoderConfig(**asdict(TINY_VOC))
    tm = Qwen3TTS.from_numpy(
        tcfg, _numpy(jm.talker_params), _numpy(jm.cp_params), _numpy(jm.vocoder_params),
        FakeTokenizer(), vocoder_config=vcfg, device="cpu",
    )
    return jm, tm


@pytest.mark.parametrize("max_length", [8, 20])
def test_synthesize_with_timing_matches_jax(models, max_length):
    jm, tm = models
    jopts = JOptions(max_length=max_length, seed=42, temperature=0.9)
    topts = SynthesisOptions(max_length=max_length, seed=42, temperature=0.9)

    jframes = jm._custom_voice_session(TEXT, "ryan", "english", jopts).run_to_completion()
    tframes = tm._custom_voice_session(TEXT, "ryan", "english", topts).run_to_completion()
    np.testing.assert_array_equal(tframes, jframes)

    jaudio, jtiming = jm.synthesize_with_timing(TEXT, "ryan", "english", jopts)
    taudio, ttiming = tm.synthesize_with_timing(TEXT, "ryan", "english", topts)
    assert ttiming.generation_frames == jtiming.generation_frames == len(jframes)
    assert taudio.samples.shape == jaudio.samples.shape
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0, atol=1e-5)
    assert np.abs(taudio.samples - jaudio.samples).max() <= 1e-4 * np.abs(jaudio.samples).max()

    # synthesize_with_voice decodes chunk by chunk on the streaming vocoder
    # (run_to_audio): the staged decode's audio up to matmul-tiling ulps,
    # the JAX package's bar for the same pair (tests/test_pipeline.py).
    voiced = tm.synthesize_with_voice(TEXT, "ryan", "english", topts)
    assert voiced.samples.shape == taudio.samples.shape
    np.testing.assert_allclose(voiced.samples, taudio.samples, rtol=0, atol=2e-6)
    jvoiced = jm.synthesize_with_voice(TEXT, "ryan", "english", jopts)
    np.testing.assert_allclose(voiced.samples, jvoiced.samples, rtol=0, atol=1e-5)


def test_one_frame_step_matches_jax(models):
    """The frame step of ``__graft_entry__.entry()`` (embed -> CP 15 codes ->
    talker step -> penalties -> sample) at the tiny size, both packages."""
    jm, tm = models
    tcfg_j, cpcfg_j = jm.config.talker, jm.config.code_predictor
    tcfg_t, cpcfg_t = tm.config.talker, tm.config.code_predictor
    rs = np.random.RandomState(0)
    hidden = rs.randn(1, 1, tcfg_j.hidden_size).astype(np.float32)
    penalty = (rs.rand(tcfg_j.codec_vocab_size) < 0.01).astype(np.float32)
    token, pos, uniform, max_seq = 100, 10, np.float32(0.5), 32

    jcache = jnn.init_kv_cache(tcfg_j.layer_stack(), 1, max_seq, jnp.float32)
    jsem = jtalker.embed_codec(jm.talker_params, jnp.int32(token))[None, None, :]
    jcodes = jcp.predict_acoustic_codes(jm.cp_params, cpcfg_j, jnp.asarray(hidden), jsem)
    jstep = jsem + jcp.acoustic_embedding_sum(jm.cp_params, jcodes)
    jh, jlogits, jcache = jtalker.decode_step(jm.talker_params, tcfg_j, jstep, jnp.int32(pos), jcache)
    jscfg = jsampling.SamplingConfig()
    jlogits = jsampling.apply_generation_penalties(
        jlogits, jnp.asarray(penalty), jsampling.build_suppression_mask(), jscfg, jnp.int32(5)
    )
    jnext = int(jsampling.sample(jlogits, jscfg, jnp.float32(uniform))[0])

    with torch.no_grad():
        tcache = tnn.init_kv_cache(tcfg_t.layer_stack(), 1, max_seq, torch.float32)
        tsem = ttalker.embed_codec(tm.talker_params, torch.tensor(token))[None, None, :]
        tcodes = tcp.predict_acoustic_codes(tm.cp_params, cpcfg_t, torch.from_numpy(hidden), tsem)
        tstep = tsem + tcp.acoustic_embedding_sum(tm.cp_params, tcodes)
        th, tlogits = ttalker.decode_step(tm.talker_params, tcfg_t, tstep, pos, tcache)
        tscfg = tsampling.SamplingConfig()
        tlogits = tsampling.apply_generation_penalties(
            tlogits, torch.from_numpy(penalty), tsampling.build_suppression_mask(), tscfg, 5
        )
        tnext = int(tsampling.sample(tlogits, tscfg, torch.tensor(uniform))[0])

    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert tnext == jnext
    np.testing.assert_allclose(tcache.k[:, :, pos].numpy(), np.asarray(jcache.k[:, :, pos]), rtol=0, atol=1e-5)


def test_cpu_model_keeps_talker_unfused(models):
    """On the CPU the talker keeps its separate projections, as the JAX main
    path does: decode steps take the layer path."""
    _, tm = models
    layers = tm.talker_params["layers"]
    assert "q_proj" in layers and "qkv_proj" not in layers
    cache = tnn.init_kv_cache(tm.config.talker.layer_stack(), 1, 32, torch.float32)
    assert not ttalker.stream_plane_mode(tm.talker_params, tm.config.talker, cache)


def _split_free_port(quantize_int8: bool, fuse_talker: bool = False):
    """The port's model of the split-free tiny config of
    tests/test_fused_layer.py on the CPU (its talker tree handed in fused
    when ``fuse_talker``), with the JAX arguments (config, trees, tokenizer)
    and vocoder config."""
    from dataclasses import asdict

    from qwen3_tts_tpu.models import weights as JW
    from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, ModelConfig, ModelType, TalkerConfig
    from test_fused_layer import _tiny_pipeline_args

    args, tiny_voc = _tiny_pipeline_args()
    jcfg = args[0]
    tcfg = ModelConfig(
        model_type=ModelType.CUSTOM_VOICE, model_size="0b6",
        talker=TalkerConfig(**asdict(jcfg.talker)),
        code_predictor=CodePredictorConfig(**asdict(jcfg.code_predictor)),
    )
    trees = (JW.fuse_model_params(args[1]) if fuse_talker else args[1], args[2], args[3])
    tm = Qwen3TTS.from_numpy(
        tcfg, *(_numpy(t) for t in trees), args[4],
        vocoder_config=tvoc.VocoderConfig(**asdict(tiny_voc)), quantize_int8=quantize_int8, device="cpu",
    )
    return tm, args, tiny_voc


def test_fused_f32_talker_pipeline_matches_jax_plain_pack(monkeypatch):
    """A fused f32 talker handed to the port on the CPU: decode steps take
    the whole-step path (``talker_step_plain``); against the JAX model with
    its opt-in plain stream pack (the interpret-mode ``streamed_talker_step``
    with ``quantized=False``), frames token-exact over 4 frames, audio
    within atol 1e-5."""
    from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS

    tm, args, tiny_voc = _split_free_port(quantize_int8=False, fuse_talker=True)
    monkeypatch.setenv("QWEN3_TTS_BF16_STREAM_PACK", "1")
    jm = JQwen3TTS(*args, vocoder_config=tiny_voc)
    assert jm.talker_params["stream_pack"]["tiles"].dtype == jnp.float32
    assert tm.talker_params["layers"]["qkv_proj"].dtype == torch.float32
    text = "plain pack"
    jopts = JOptions(max_length=4, seed=42)
    topts = SynthesisOptions(max_length=4, seed=42)

    want = jm._custom_voice_session(text, "ryan", "english", jopts).run_to_completion()
    session = tm._custom_voice_session(text, "ryan", "english", topts)
    assert ttalker.stream_plane_mode(tm.talker_params, tm.config.talker, session.state.cache)
    got = session.run_to_completion()
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got, want)

    jaudio, _ = jm.synthesize_with_timing(text, "ryan", "english", jopts)
    taudio, ttiming = tm.synthesize_with_timing(text, "ryan", "english", topts)
    assert ttiming.generation_frames == len(want)
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def int8_models():
    """The split-free tiny model of tests/test_fused_layer.py in weight-only
    int8: the port quantizes the f32 trees itself (bit for bit as JAX)."""
    from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS

    tm, args, tiny_voc = _split_free_port(quantize_int8=True)
    j_packs = JQwen3TTS(*args, vocoder_config=tiny_voc, quantize_int8=True)
    assert "stream_pack" in j_packs.talker_params and "stream_pack" in j_packs.cp_params
    j_plain = JQwen3TTS(*args, vocoder_config=tiny_voc, quantize_int8=True)
    j_plain.talker_params.pop("stream_pack")
    j_plain.cp_params.pop("stream_pack")
    return tm, j_plain, j_packs


def test_int8_pipeline_matches_jax(int8_models):
    """Against the JAX int8 model without its stream packs (the layer scan
    and the per-matmul dequant path, which round where the port's plain
    versions round): frames token-exact, audio within atol 1e-5. Against the
    JAX int8 model with both packs (its interpret-mode streamed kernels,
    which sum in other orders): the JAX package's own bar for that pair
    (tests/test_fused_layer.py::test_streamed_talker_full_pipeline_codes),
    the first 2 frames equal and >= 90% of all codes."""
    tm, j_plain, j_packs = int8_models
    text = "stream talker"
    assert tm.talker_params["layers"]["qkv_proj"]["q8"].dtype == torch.int8
    jopts = JOptions(max_length=6, seed=42)
    topts = SynthesisOptions(max_length=6, seed=42)

    want = j_plain._custom_voice_session(text, "ryan", "english", jopts).run_to_completion()
    session = tm._custom_voice_session(text, "ryan", "english", topts)
    assert ttalker.stream_plane_mode(tm.talker_params, tm.config.talker, session.state.cache)
    got = session.run_to_completion()
    np.testing.assert_array_equal(got, want)

    jaudio, _ = j_plain.synthesize_with_timing(text, "ryan", "english", jopts)
    taudio, ttiming = tm.synthesize_with_timing(text, "ryan", "english", topts)
    assert ttiming.generation_frames == len(want)
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0, atol=1e-5)

    packed = j_packs.synthesize_streaming(text, "ryan", "english", jopts).run_to_completion()
    n = min(len(got), len(packed))
    assert n >= 2
    np.testing.assert_array_equal(got[:2], packed[:2])
    assert (got[:n] == packed[:n]).mean() >= 0.9
