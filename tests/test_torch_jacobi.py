"""Jacobi code prediction in the port against the JAX package's (f32, CPU).

``decode_mode="jacobi"`` makes the code predictor iterate the whole
16-row frame through the no-cache stack until its codes stop changing
(``predict_acoustic_codes_jacobi``); the greedy fixed point is the
sequential frame. Held here, each token for token:

* the port's Jacobi against the JAX package's ``predict_acoustic_codes_jacobi``
  on the configs of ``tests/test_jacobi_cp.py`` (with and without the mtp
  projection, 4 trials; unfused and fused trees), and against the port's
  sequential route; on an int8 tree with quantized heads too (a differing
  code is reported with its top-2 margin);
* the batched form (each stream frozen at its own fixed point) against
  single runs that take different numbers of iterations;
* ``nn.run_layer_stack_nocache`` against the JAX function, within 1e-5 of
  the output's scale, on fused and unfused trees;
* the tiny model built with ``decode_mode="jacobi"`` in both packages:
  ``synthesize_with_timing``, a streamed session chunk by chunk and a batch
  of 3 whose streams end at different frames: frames token-exact, audio
  within 1e-5; and that the route is taken, not ignored;
* the seeded 1.7B-width code predictor (``cp_fixture``) through the port's
  Jacobi on the CPU, equal to the committed JAX fixture;
* ``TransferAudit`` over a Jacobi frame loop.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.config import CodePredictorConfig as JCodePredictorConfig
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu_torch import cp_fixture
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import tokens as T
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig
from qwen3_tts_tpu_torch.ops import fused_layer as tfl
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from qwen3_tts_tpu_torch.profiling import count_host_transfers
from test_torch_batch import EOS_TEXTS, check_batch, eos_models
from test_torch_nn import STACK, _layer_params
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

TEXT = "Hello there, general."
TRIALS = 4


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jacobi_cfg(with_projection: bool) -> JCodePredictorConfig:
    """``tests/test_jacobi_cp.py``'s config."""
    return JCodePredictorConfig(
        hidden_size=32 if with_projection else 64, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=96,
        codec_embed_dim=64 if with_projection else None,
    )


def _port_cfg(jcfg, **kw) -> CodePredictorConfig:
    return replace(CodePredictorConfig(**{f: getattr(jcfg, f) for f in CodePredictorConfig.__dataclass_fields__}),
                   **kw)


def _inputs(cfg, trial: int) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_jacobi_cp.py``'s inputs of trial ``trial``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(100 + trial))
    return (np.array(jax.random.normal(k1, (1, 1, cfg.embed_dim), jnp.float32)),
            np.array(jax.random.normal(k2, (1, 1, cfg.embed_dim), jnp.float32)))


_jax_jacobi = jax.jit(jcp.predict_acoustic_codes_jacobi, static_argnums=(1, 4))


def _margins(params: dict, cfg: CodePredictorConfig, hidden, semantic, codes: torch.Tensor) -> list:
    """Each code's top-2 logit margin in the port's pass over ``codes``."""
    prefix = tfl.mtp_project(params, torch.cat([hidden, semantic], dim=1))
    top2 = torch.topk(tcp.jacobi_logits(params, cfg, prefix, codes.long()[None]).float()[0], 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _check_codes(got: torch.Tensor, want: np.ndarray, params, cfg, hidden, semantic, what: str) -> None:
    if not np.array_equal(got.numpy(), want):
        g = int(np.nonzero(got.numpy() != want)[0][0])
        margin = _margins(params, cfg, hidden, semantic, got)[g]
        pytest.fail(f"{what}: code {g} is {int(got[g])}, JAX {int(want[g])} (port's top-2 margin {margin:.3e})")


@pytest.mark.parametrize("with_projection", [False, True])
def test_jacobi_matches_jax_and_sequential(with_projection):
    """Unfused and fused trees: the port's Jacobi equals the JAX package's
    and the port's sequential route, trial by trial, within 16 passes."""
    jcfg = _jacobi_cfg(with_projection)
    base = JW.init_code_predictor_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    jac, seq = _port_cfg(jcfg, decode_mode="jacobi"), _port_cfg(jcfg)
    unfused = TW.from_numpy_tree(_numpy(base), "cpu")
    trees = {"unfused": unfused, "fused": TW.fuse_model_params(unfused)}
    for trial in range(TRIALS):
        h, s = _inputs(jcfg, trial)
        want = np.asarray(_jax_jacobi(base, jcfg, jnp.asarray(h), jnp.asarray(s)))
        th, ts = torch.from_numpy(h), torch.from_numpy(s)
        for name, tree in trees.items():
            before = tcp.predict_acoustic_codes_jacobi.iterations
            got = tcp.predict_acoustic_codes(tree, jac, th, ts)
            passes = tcp.predict_acoustic_codes_jacobi.iterations - before
            assert got.dtype == torch.int32 and 2 <= passes <= tcp.JACOBI_MAX_ITERS, passes
            _check_codes(got, want, tree, jac, th, ts, f"{name} trial {trial}")
            np.testing.assert_array_equal(tcp.predict_acoustic_codes(tree, seq, th, ts).numpy(), want)


@pytest.mark.parametrize("with_projection", [False, True])
def test_int8_jacobi_matches_jax(with_projection):
    """An int8 tree (layers and the quantized head stack [G, H, V] / [G, V],
    the JAX package's layout): the port's Jacobi equals the JAX package's."""
    jcfg = _jacobi_cfg(with_projection)
    base = jq.quantize_code_predictor_params(
        JW.fuse_model_params(JW.init_code_predictor_params(jax.random.PRNGKey(6), jcfg, jnp.float32)))
    tree = TW.from_numpy_tree(_numpy(base), "cpu")
    g, hdim, v = jcfg.num_acoustic, jcfg.hidden_size, jcfg.vocab_size
    assert tree["lm_heads"]["q8"].shape == (g, hdim, v) and tree["lm_heads"]["q8"].dtype == torch.int8
    assert tree["lm_heads"]["scale"].shape == (g, v) and tree["lm_heads"]["scale"].dtype == torch.float32
    cfg = _port_cfg(jcfg, decode_mode="jacobi")
    for trial in range(TRIALS):
        h, s = _inputs(jcfg, trial)
        want = np.asarray(_jax_jacobi(base, jcfg, jnp.asarray(h), jnp.asarray(s)))
        th, ts = torch.from_numpy(h), torch.from_numpy(s)
        _check_codes(tcp.predict_acoustic_codes(tree, cfg, th, ts), want, tree, cfg, th, ts, f"int8 trial {trial}")


def test_batched_jacobi_freezes_each_stream():
    """B = 3 frames at once equal three single runs, each stream with its own
    pass count (they differ here), and the loop runs the most of them."""
    jcfg = _jacobi_cfg(False)
    base = JW.init_code_predictor_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tree = TW.from_numpy_tree(_numpy(base), "cpu")
    cfg = _port_cfg(jcfg, decode_mode="jacobi")
    inputs = [tuple(torch.from_numpy(a) for a in _inputs(jcfg, t)) for t in range(3)]
    singles, counts = [], []
    for h, s in inputs:
        before = tcp.predict_acoustic_codes_jacobi.iterations
        singles.append(tcp.predict_acoustic_codes_jacobi(tree, cfg, h, s))
        counts.append(tcp.predict_acoustic_codes_jacobi.iterations - before)
    assert len(set(counts)) > 1, counts
    h = torch.cat([x for x, _ in inputs])
    s = torch.cat([y for _, y in inputs])
    before = tcp.predict_acoustic_codes_jacobi.iterations
    codes = tcp.predict_acoustic_codes_jacobi_batch(tree, cfg, h, s)
    assert tcp.predict_acoustic_codes_jacobi.iterations - before == max(counts)
    np.testing.assert_array_equal(codes.numpy(), torch.stack(singles).numpy())
    np.testing.assert_array_equal(tcp.predict_acoustic_codes_batch(tree, cfg, h, s).numpy(), codes.numpy())
    # A bound below the fixed point stops every stream there, as the JAX loop does.
    capped = tcp.predict_acoustic_codes_jacobi_batch(tree, cfg, h, s, max_iters=3)
    for (x, y), got in zip(inputs, capped):
        want = _jax_jacobi(base, jcfg, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fused", [False, True])
def test_layer_stack_nocache_matches_jax(fused):
    rs = np.random.RandomState(11 + fused)
    jparams = _layer_params(rs, fused)
    tparams = TW.from_numpy_tree({k: np.asarray(v) for k, v in jparams["layers"].items()}, "cpu")
    x = rs.randn(2, 16, STACK["hidden_size"]).astype(np.float32)
    want = np.asarray(jnn.run_layer_stack_nocache(jparams["layers"], jnp.asarray(x), jnn.LayerStackConfig(**STACK)))
    got = tnn.run_layer_stack_nocache(tparams, torch.from_numpy(x), tnn.LayerStackConfig(**STACK)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unknown_decode_mode_raises():
    jcfg = _jacobi_cfg(False)
    tree = TW.from_numpy_tree(_numpy(JW.init_code_predictor_params(jax.random.PRNGKey(5), jcfg, jnp.float32)), "cpu")
    h, s = (torch.from_numpy(a) for a in _inputs(jcfg, 0))
    with pytest.raises(ValueError, match="decode_mode"):
        tcp.predict_acoustic_codes(tree, _port_cfg(jcfg, decode_mode="speculative"), h, s)


# --- the tiny model with decode_mode="jacobi" in both packages ---------------


def _jacobi_models(jm, tm) -> tuple:
    jcfg = replace(jm.config, code_predictor=replace(jm.config.code_predictor, decode_mode="jacobi"))
    tcfg = replace(tm.config, code_predictor=replace(tm.config.code_predictor, decode_mode="jacobi"))
    return (JP.Qwen3TTS(jcfg, jm.talker_params, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                        vocoder_config=jm.vocoder_config),
            Qwen3TTS(tcfg, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                     vocoder_config=tm.vocoder_config))


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def jacobi_models(models):
    return _jacobi_models(*models)


def test_jacobi_route_is_taken(jacobi_models, monkeypatch):
    """The port's frame loop runs Jacobi for a jacobi config (the parent
    ignored the mode and ran the sequential layer path)."""
    _, tm = jacobi_models
    assert tcp.cp_route(tm.cp_params, tm.config.code_predictor) == "jacobi"
    assert tm.cp_frame_pack is None and tm.cp_step_pack is None

    def refuse(*args, **kwargs):
        raise AssertionError("a sequential code-predictor route ran under decode_mode='jacobi'")

    monkeypatch.setattr(tfl, "cp_frame_layers_batch", refuse)
    monkeypatch.setattr(tcp, "_predict_acoustic_codes_fused", refuse)
    before = tcp.predict_acoustic_codes_jacobi.iterations
    opts = SynthesisOptions(max_length=4, min_new_tokens=4, seed=42, temperature=0.9)
    audio, timing = tm.synthesize_with_timing(TEXT, "ryan", "english", opts)
    assert timing.generation_frames == 4 and len(audio) == 4 * T.SAMPLES_PER_FRAME
    assert tcp.predict_acoustic_codes_jacobi.iterations - before >= 2 * 4


@pytest.mark.parametrize("max_length", [8, 20])
def test_staged_matches_jax(jacobi_models, max_length):
    jm, tm = jacobi_models
    kw = dict(max_length=max_length, seed=42, temperature=0.9)
    jopts, topts = JP.SynthesisOptions(**kw), SynthesisOptions(**kw)
    jframes = jm._custom_voice_session(TEXT, "ryan", "english", jopts).run_to_completion()
    tframes = tm._custom_voice_session(TEXT, "ryan", "english", topts).run_to_completion()
    np.testing.assert_array_equal(tframes, jframes)
    jaudio, _ = jm.synthesize_with_timing(TEXT, "ryan", "english", jopts)
    taudio, ttiming = tm.synthesize_with_timing(TEXT, "ryan", "english", topts)
    assert ttiming.generation_frames == len(jframes)
    np.testing.assert_allclose(taudio.samples, jaudio.samples, rtol=0, atol=1e-5)


def test_streamed_matches_jax(jacobi_models):
    jm, tm = jacobi_models
    kw = dict(max_length=20, seed=42, temperature=0.9)
    js = jm.synthesize_streaming(TEXT, "ryan", "english", JP.SynthesisOptions(**kw))
    ts = tm.synthesize_streaming(TEXT, "ryan", "english", SynthesisOptions(**kw))
    want = [np.asarray(c.samples) for c in js]
    got = []
    while (chunk := ts.next_chunk()) is not None:
        got.append(np.asarray(chunk.samples))
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    n = ts.frames_generated
    assert n == int(js.state.frame_idx)
    np.testing.assert_array_equal(ts.state.frames[:n].numpy(), np.asarray(js.state.frames)[:n])


def test_batch_with_uneven_eos_matches_jax(models):
    """B = 3 streams that end at different frames (the codec head's EOS
    column boosted), each frozen at its EOS; the batched Jacobi code
    predictor under the batch loop."""
    jm, tm = _jacobi_models(*eos_models(models))
    # Seeds 8, 9, 10: the third stream meets EOS at frame 8, the others run on.
    frames, _ = check_batch(jm, tm, EOS_TEXTS[:3], max_length=16, seed=8, temperature=0.9)
    counts = [len(f) for f in frames]
    assert len(set(counts)) > 1 and min(counts) < 16, counts


def test_jacobi_loop_host_reads(jacobi_models):
    """The batch-1 Jacobi loop reads the device once a frame (``done``) and
    once a pass but the first (whether the codes changed): the eager cost of
    the fixed-point test. At most frames + passes + 1."""
    _, tm = jacobi_models
    frames = 6
    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=3)
    session = tm._custom_voice_session(TEXT, "ryan", "english", opts)
    before = tcp.predict_acoustic_codes_jacobi.iterations
    _, reads = count_host_transfers(session._advance, frames)
    passes = tcp.predict_acoustic_codes_jacobi.iterations - before
    assert session.state.frame_idx == frames
    assert reads <= frames + passes + 1, (reads, passes)


def test_port_jacobi_gives_the_1p7b_fixture():
    """The seeded 1.7B-width code predictor (fused, as the card holds it)
    through the port's plain Jacobi: the committed JAX codes (its sequential
    frames: a greedy fixed point equals them)."""
    cfg = replace(cp_fixture.config(), decode_mode="jacobi")
    params = TW.fuse_model_params(TW.from_numpy_tree(cp_fixture.numpy_params(cfg), "cpu"))
    fixture = cp_fixture.load()
    got = [tcp.predict_acoustic_codes(params, cfg, torch.from_numpy(h), torch.from_numpy(s)).tolist()
           for h, s in cp_fixture.numpy_inputs(cfg)]
    assert got == fixture["codes"]
