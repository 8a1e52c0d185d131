"""MRoPE and tiered decode attention in the port against the JAX package's
(f32, CPU).

Mirrors ``tests/test_mrope.py`` and ``tests/test_attention_tiering.py``:

* ``decode_attention_tiers`` equal to the JAX function; ``tiered_decode_attention``
  against the JAX function and against dense attention, atol 1e-6, at
  positions in every window of a 600-row cache;
* a frame loop on a cache of more than 512 rows with ``decode_tiering`` on
  against off and against the JAX package's tiered loop: frames token-exact,
  and the tiered window taken; the batched loop ignores the flag;
* ``mrope_cos_sin``: equal streams bit-equal to ``rope_cos_sin``, distinct
  streams within 1e-6 of the JAX tables;
* ``run_layer_stack(..., positions_thw=)``: equal streams bit-equal to plain
  positions, distinct streams within 1e-5 of the JAX ``[3, S]`` stack and
  different from the plain one;
* the talker's ``layer_stack()`` carries ``mrope_section`` and
  ``decode_tiering`` as the JAX package's does.
"""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.generation import core as jcore
from qwen3_tts_tpu.generation import prefill as jprefill
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.config import CodePredictorConfig as JCodePredictorConfig
from qwen3_tts_tpu.models.config import TalkerConfig as JTalkerConfig
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import rng
from qwen3_tts_tpu.ops import sampling as jsampling
from qwen3_tts_tpu_torch.generation import core as tcore
from qwen3_tts_tpu_torch.generation import prefill as tprefill
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, TalkerConfig
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)

SECTION = (24, 20, 20)
HEAD_DIM = 128  # head_dim/2 = 64 = sum(SECTION)
TIER_POSITIONS = (0, 1, 255, 256, 257, 511, 512, 599)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_tiers_match_jax():
    for max_seq in (2314, 2624, 600, 513, 512, 100):
        assert tnn.decode_attention_tiers(max_seq) == jnn.decode_attention_tiers(max_seq)
    assert tnn.decode_attention_tiers(2624) == (256, 512, 1024, 2048, 2624)


def test_tiered_equals_jax_and_dense():
    rs = np.random.RandomState(0)
    b, h, kv, d, max_seq = 1, 4, 2, 8, 600
    q, ck, cv = (rs.randn(*shape).astype(np.float32) for shape in ((b, 1, h, d), (b, max_seq, kv, d),
                                                                    (b, max_seq, kv, d)))
    scale = 1.0 / d**0.5
    tiered = jax.jit(jnn.tiered_decode_attention, static_argnames=("scale",))
    for pos in TIER_POSITIONS:
        mask = (np.arange(max_seq) <= pos)[None, None, None, None, :]
        want = np.asarray(tiered(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(mask), scale,
                                 pos=jnp.int32(pos)))
        tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, ck, cv, mask))
        got = tnn.tiered_decode_attention(tq, tk, tv, tm, scale, pos).numpy()
        dense = tnn.gqa_attention(tq, tk, tv, tm, scale).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"pos {pos}")
        np.testing.assert_allclose(got, dense, rtol=0, atol=1e-6, err_msg=f"pos {pos}")


# --- the frame loop on a cache of more than 512 rows --------------------------

LOOP_TALKER = dict(text_embed_dim=16, hidden_size=32, text_proj_intermediate=16, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=8)
LOOP_CP = dict(hidden_size=32, intermediate_size=32, num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, vocab_size=64)
MAX_NEW = 6
MAX_SEQ = 10 + 1024 + 8  # > 512 rows: tiering engages
TEXT_IDS = [5, 9, 3, 0]


@pytest.fixture(scope="module")
def loop_params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jt = JW.init_talker_params(k1, JTalkerConfig(**LOOP_TALKER), jnp.float32)
    jc = JW.init_code_predictor_params(k2, JCodePredictorConfig(**LOOP_CP), jnp.float32)
    return (jt, jc), (TW.from_numpy_tree(_numpy(jt), "cpu"), TW.from_numpy_tree(_numpy(jc), "cpu"))


def _jax_loop(params, tiering: bool) -> tuple:
    tparams, cparams = params
    cfg, cpcfg = JTalkerConfig(**LOOP_TALKER, decode_tiering=tiering), JCodePredictorConfig(**LOOP_CP)
    scfg = jsampling.SamplingConfig()
    uniforms = jnp.asarray(rng.pcg_uniform_sequence(42, MAX_NEW + 1))
    cache = jnn.init_kv_cache(cfg.layer_stack(), 1, MAX_SEQ, jnp.float32)
    state, trailing, tl, pad = jprefill.custom_voice_impl(
        tparams, cfg, scfg, jnp.array(TEXT_IDS, jnp.int32), jnp.int32(3), jnp.int32(3061), jnp.int32(2050), cache,
        uniforms, MAX_NEW)
    final = jcore.generate_frames(tparams, cparams, cfg, cpcfg, scfg, state, trailing, tl, pad, uniforms,
                                  jnp.int32(MAX_NEW))
    return np.asarray(final.frames), int(final.frame_idx)


def _port_loop(params, tiering: bool) -> tuple:
    tparams, cparams = params
    cfg, cpcfg = TalkerConfig(**LOOP_TALKER, decode_tiering=tiering), CodePredictorConfig(**LOOP_CP)
    scfg = tsampling.SamplingConfig()
    uniforms = torch.from_numpy(rng.pcg_uniform_sequence(42, MAX_NEW + 1))
    cache = tnn.init_kv_cache(cfg.layer_stack(), 1, MAX_SEQ, torch.float32)
    state, trailing, tl, pad = tprefill.custom_voice_impl(
        tparams, cfg, scfg, torch.tensor(TEXT_IDS), 3, 3061, 2050, cache, uniforms, MAX_NEW)
    final = tcore.generate_frames(tparams, cparams, cfg, cpcfg, scfg, state, trailing, tl, pad, uniforms, MAX_NEW)
    return final.frames.numpy(), final.frame_idx


@pytest.fixture
def tier_calls(monkeypatch):
    """The windows ``tiered_decode_attention`` is called with, in order."""
    calls = []
    routed = tnn.tiered_decode_attention

    def spy(q, cache_k, cache_v, mask, scale, pos):
        calls.append(pos)
        return routed(q, cache_k, cache_v, mask, scale, pos)

    monkeypatch.setattr(tnn, "tiered_decode_attention", spy)
    return calls


def test_frame_loop_tiered_matches_dense_and_jax(loop_params, tier_calls):
    jparams, tparams = loop_params
    dense, n_dense = _port_loop(tparams, tiering=False)
    assert tier_calls == []
    tiered, n_tiered = _port_loop(tparams, tiering=True)
    layers = LOOP_TALKER["num_hidden_layers"]
    # One tiered attention a layer and a step, at the rows each step writes.
    assert tier_calls == [p for p in range(10, 10 + n_tiered) for _ in range(layers)], tier_calls
    want, n_want = _jax_loop(jparams, tiering=True)
    assert n_dense == n_tiered == n_want == MAX_NEW
    np.testing.assert_array_equal(tiered, dense)
    np.testing.assert_array_equal(tiered, want)


def test_batched_loop_ignores_tiering(loop_params, tier_calls):
    """Two streams on a 1042-row cache: the batched loop takes dense attention
    with the flag set (per-stream positions are device tensors), and its
    frames equal the loop without it."""
    _, (tparams, cparams) = loop_params
    scfg = tsampling.SamplingConfig()
    uniforms = torch.from_numpy(np.stack([rng.pcg_uniform_sequence(s, MAX_NEW + 1) for s in (42, 43)]))

    def run(tiering: bool):
        cfg = TalkerConfig(**LOOP_TALKER, decode_tiering=tiering)
        rows = [tprefill.custom_voice_rows(tparams, torch.tensor(ids), n, 3061, 2050)
                for ids, n in ((TEXT_IDS, 3), ([7, 2, 0, 0], 2))]
        cache = tnn.init_kv_cache(cfg.layer_stack(), 2, MAX_SEQ, torch.float32)
        state, trailing, tls, pad = tprefill.finish_batch(tparams, cfg, scfg, rows, cache, uniforms, MAX_NEW)
        tcore.generate_frames_batch(tparams, cparams, cfg, CodePredictorConfig(**LOOP_CP), scfg, state, trailing,
                                    tls, pad, uniforms, [MAX_NEW, MAX_NEW])
        return state.frames.numpy()

    np.testing.assert_array_equal(run(True), run(False))
    assert tier_calls == []


def test_tiering_needs_host_position():
    """Tiered attention with a per-stream LongTensor position raises: the
    window is picked on the host, at batch 1."""
    cfg = tnn.LayerStackConfig(hidden_size=32, intermediate_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
                               head_dim=8, decode_tiering=True)
    rs = np.random.RandomState(1)
    layers = TW.from_numpy_tree({k: np.asarray(v) for k, v in JW.init_talker_params(
        jax.random.PRNGKey(0), JTalkerConfig(**LOOP_TALKER), jnp.float32)["layers"].items()}, "cpu")
    layers = {k: v[:1] for k, v in layers.items()}
    cache = tnn.init_kv_cache(cfg, 2, 600, torch.float32)
    x = torch.from_numpy(rs.randn(2, 1, 32).astype(np.float32))
    pos = torch.tensor([5, 9])
    with pytest.raises(ValueError, match="host integer"):
        tnn.run_layer_stack(layers, x, cfg, cache, pos[:, None], pos)
    dense = tnn.run_layer_stack(layers, x, replace(cfg, decode_tiering=False), cache, pos[:, None], pos)
    assert dense.shape == (2, 1, 32)


# --- MRoPE ---------------------------------------------------------------------


def test_mrope_tables():
    inv_freq = tnn.rope_inv_freq(HEAD_DIM, 1e6)
    pos = torch.arange(7, dtype=torch.float32) + 3
    cos1, sin1 = tnn.rope_cos_sin(pos, inv_freq)
    cos3, sin3 = tnn.mrope_cos_sin(torch.stack([pos, pos, pos]), inv_freq, SECTION)
    assert torch.equal(cos1, cos3) and torch.equal(sin1, sin3)

    pos_thw = np.random.RandomState(0).randint(0, 50, size=(3, 9)).astype(np.float32)
    want = jnn.mrope_cos_sin(jnp.asarray(pos_thw), jnn.rope_inv_freq(HEAD_DIM, 1e6), SECTION)
    got = tnn.mrope_cos_sin(torch.from_numpy(pos_thw), inv_freq, SECTION)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert not torch.equal(got[0], tnn.rope_cos_sin(torch.from_numpy(pos_thw[0]), inv_freq)[0])


MROPE_TALKER = dict(LOOP_TALKER, mrope_section=(2, 1, 1))


@pytest.fixture(scope="module")
def mrope_stack():
    jcfg = JTalkerConfig(**MROPE_TALKER)
    jparams = JW.init_talker_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 5, 32), jnp.float32))
    return jcfg, jparams["layers"], TW.from_numpy_tree(_numpy(jparams["layers"]), "cpu"), x


def _port_stack(layers, x, positions=None, positions_thw=None, cfg=None):
    cfg = cfg or TalkerConfig(**MROPE_TALKER).layer_stack()
    cache = tnn.init_kv_cache(cfg, 1, 5, torch.float32)
    return tnn.run_layer_stack(layers, torch.from_numpy(x), cfg, cache, positions, 0, positions_thw=positions_thw)


def test_layer_stack_mrope_equal_streams(mrope_stack):
    _, _, layers, x = mrope_stack
    pos = torch.arange(5)
    plain = _port_stack(layers, x, pos)
    three = _port_stack(layers, x, positions_thw=torch.stack([pos, pos, pos]))
    assert torch.equal(plain, three)


def test_layer_stack_mrope_distinct_streams_match_jax(mrope_stack):
    jcfg, jlayers, layers, x = mrope_stack
    pos = np.arange(5, dtype=np.int32)
    thw = np.stack([pos, pos * 0 + 2, pos * 0 + 4])
    want, _ = jnn.run_layer_stack(jlayers, jnp.asarray(x), jcfg.layer_stack(),
                                  jnn.init_kv_cache(jcfg.layer_stack(), 1, 5, jnp.float32), jnp.asarray(thw),
                                  jnp.int32(0))
    got = _port_stack(layers, x, positions_thw=torch.from_numpy(thw).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    plain = _port_stack(layers, x, torch.from_numpy(pos).long()).numpy()
    assert not np.allclose(got, plain)
    with pytest.raises(ValueError, match="mrope_section"):
        _port_stack(layers, x, positions_thw=torch.from_numpy(thw).long(),
                    cfg=TalkerConfig(**dict(MROPE_TALKER, mrope_section=None)).layer_stack())


def test_layer_stack_configs_match_jax():
    for kw in (dict(LOOP_TALKER), dict(MROPE_TALKER, decode_tiering=True)):
        assert asdict(TalkerConfig(**kw).layer_stack()) == asdict(JTalkerConfig(**kw).layer_stack())
    assert asdict(CodePredictorConfig(**LOOP_CP).layer_stack()) == asdict(JCodePredictorConfig(**LOOP_CP).layer_stack())
