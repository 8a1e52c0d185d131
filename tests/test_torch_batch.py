"""Batched synthesis, the port against the JAX package (f32, CPU).

The tiny Base model of ``tests/test_torch_voice_clone.py`` (its vocoder
drawn so that the audio has a real scale) goes to both packages. With the
same texts, speakers, options and seeds, ``synthesize_batch`` must give
every stream's frames token for token (each layout group's loop, read
through ``_generate_batch_group``) and its audio within atol 1e-5 of the
JAX package's, greedy and under seeded PCG sampling; here for preset
speakers with texts of different lengths, default and explicit seeds, and
uneven EOS (a model whose codec head's EOS column is scaled by
``EOS_BOOST``, so that streams end at different frames). Each batched
stream must also equal the port's own batch-1 run of it. Below the
pipeline: a decode step of B streams each at its own position against B
batch-1 steps and the JAX package's vmapped step, and kernel 4's batch rule
(``int8_matmul`` on ``[B, m, K]`` against B plain calls; its route on
``meta`` tensors). ``test_torch_batch_int8.py``, ``_clone.py``,
``_design.py`` and ``_stream.py`` take the other layouts, the int8 tree and
``synthesize_streaming_batch``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import tokens as T
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions, VoiceClonePrompt
from test_pipeline import TINY_TALKER
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

TEXTS = ["Hi", "Second one differs", "Third!"]  # 2, 12 and 6 tokens
EOS_TEXTS = ["aaaa", "bbbb", "cccc", "dddd"]  # tests/test_streaming_batch.py's uneven-EOS case, seed 7
EOS_BOOST = 3.0
AUDIO_ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return build_models()


def eos_models(models) -> tuple:
    """Both models with the codec head's EOS column scaled by ``EOS_BOOST``
    (the same trees otherwise), so that EOS comes at different frames."""
    jm, tm = models
    jtp = dict(jm.talker_params, codec_head=jm.talker_params["codec_head"].at[:, T.CODEC_EOS].multiply(EOS_BOOST))
    head = tm.talker_params["codec_head"].clone()
    head[:, T.CODEC_EOS] *= EOS_BOOST
    return (JP.Qwen3TTS(jm.config, jtp, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                        vocoder_config=jm.vocoder_config),
            Qwen3TTS(tm.config, dict(tm.talker_params, codec_head=head), tm.cp_params, tm.vocoder_params,
                     tm.tokenizer, vocoder_config=tm.vocoder_config))


def voices(model, spec: list, prompt=None) -> list:
    """Each package's speakers from a spec: a preset name, "xvector" (the
    prompt's x-vector alone), or an ICL prompt given as is."""
    cls = VoiceClonePrompt if isinstance(model, Qwen3TTS) else JP.VoiceClonePrompt
    return [cls(prompt.speaker_embedding) if v == "xvector" else v for v in spec]


def jax_frames(jm, texts, speakers, languages, options, seeds, instructs) -> list:
    """Each stream's frames from the JAX package's loops, in call order."""
    out = [None] * len(texts)
    for kind, idx in jm._split_batch_groups(speakers, instructs):
        frames, counts, _ = jm._generate_batch_group(
            kind, [texts[i] for i in idx], [speakers[i] for i in idx], [languages[i] for i in idx],
            [instructs[i] for i in idx], jm._normalize_options(options), [seeds[i] for i in idx])
        for j, i in enumerate(idx):
            out[i] = np.asarray(frames[j])[:int(counts[j])]
    return out


def port_frames(tm, texts, speakers, languages, options, seeds, instructs) -> list:
    """Each stream's frames from the port's loops, in call order."""
    options, speakers, languages, instructs, seeds = tm._batch_args(texts, speakers, languages, options, seeds,
                                                                    instructs)
    out = [None] * len(texts)
    for kind, idx in tm._split_batch_groups(speakers, instructs):
        group = tm._prepare_batch_group(kind, [texts[i] for i in idx], [speakers[i] for i in idx],
                                        [languages[i] for i in idx], [instructs[i] for i in idx], options,
                                        [seeds[i] for i in idx])
        frames, counts = tm._generate_batch_group(group)
        for j, i in enumerate(idx):
            out[i] = frames[j][:counts[j]]
    return out


def check_batch(jm, tm, texts, jspeakers="ryan", tspeakers="ryan", languages="english", seeds=None,
                instructs=None, **kw) -> tuple[list, list]:
    """Frames token-exact and audio within ``AUDIO_ATOL`` of the JAX
    package's ``synthesize_batch``; returns the port's (frames, audio)."""
    jopts, topts = JP.SynthesisOptions(**kw), SynthesisOptions(**kw)
    b = len(texts)
    expand = (lambda v: [v] * b if isinstance(v, (str, JP.VoiceClonePrompt, VoiceClonePrompt)) else list(v))
    js, ts, langs = expand(jspeakers), expand(tspeakers), expand(languages)
    ins = instructs or [None] * b
    jseeds = seeds or [(kw.get("seed") or 0) + i for i in range(b)]
    want_frames = jax_frames(jm, texts, js, langs, jopts, jseeds, ins)
    got_frames = port_frames(tm, texts, ts, langs, topts, seeds, instructs)
    for i, (got, want) in enumerate(zip(got_frames, want_frames)):
        assert len(want) > 0
        np.testing.assert_array_equal(got, want, err_msg=f"stream {i}")
    want_audio = jm.synthesize_batch(texts, js, langs, jopts, seeds, instructs)
    got_audio = tm.synthesize_batch(texts, ts, langs, topts, seeds, instructs)
    assert len(got_audio) == len(want_audio) == b
    for i, (got, want) in enumerate(zip(got_audio, want_audio)):
        assert got.samples.shape == want.samples.shape == (len(want_frames[i]) * T.SAMPLES_PER_FRAME,)
        np.testing.assert_allclose(got.samples, want.samples, rtol=0, atol=AUDIO_ATOL, err_msg=f"stream {i}")
        assert np.abs(want.samples).max() > 1e-3
    return got_frames, [a.samples for a in got_audio]


TEMPERATURES = pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "pcg"])


@TEMPERATURES
def test_preset_batch_matches_jax(models, temperature):
    """Preset speakers (two voices) with texts of different lengths."""
    jm, tm = models
    speakers = ["ryan", "serena", "ryan"]
    check_batch(jm, tm, TEXTS, speakers, speakers, max_length=12, seed=42, temperature=temperature)


def test_seeds_match_jax(models):
    """Explicit seeds, and the default ``options.seed + i`` (``seed=None``
    counts as 0): the same as passing those seeds."""
    jm, tm = models
    got, _ = check_batch(jm, tm, TEXTS, seeds=[5, 9, 2], max_length=12, seed=42)
    default, _ = check_batch(jm, tm, TEXTS, max_length=12)
    explicit = port_frames(tm, TEXTS, "ryan", "english", SynthesisOptions(max_length=12), [0, 1, 2], None)
    for a, b, c in zip(default, explicit, got):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c) for a, c in zip(default, got))


@TEMPERATURES
def test_uneven_eos_matches_jax(models, temperature):
    """Streams that meet EOS at different frames freeze while the others go
    on; each stream's frames end at its own EOS."""
    jm, tm = eos_models(models)
    frames, _ = check_batch(jm, tm, EOS_TEXTS, max_length=16, seed=7, temperature=temperature)
    counts = [len(f) for f in frames]
    if temperature:
        assert len(set(counts)) > 1 and min(counts) < 16, counts
    assert all(f[-1, 0] != T.CODEC_EOS for f in frames)


def test_batch_streams_equal_solo_runs(models):
    """Each stream of a batch (uneven EOS, PCG) gives the frames of its own
    batch-1 session with its seed, and its audio that session's decode."""
    _, tm = eos_models(models)
    opts = SynthesisOptions(max_length=16, seed=7)
    frames = port_frames(tm, EOS_TEXTS, "ryan", "english", opts, None, None)
    audio = tm.synthesize_batch(EOS_TEXTS, options=opts)
    for i, text in enumerate(EOS_TEXTS):
        solo = tm._custom_voice_session(text, "ryan", "english", replace(opts, seed=7 + i)).run_to_completion()
        np.testing.assert_array_equal(frames[i], solo)
        np.testing.assert_allclose(audio[i].samples, tm.decode_codes(solo).samples, rtol=0, atol=AUDIO_ATOL)


def test_decode_step_per_stream_positions(models):
    """A decode step of 3 streams, each at its own position over its own
    cache rows, against 3 batch-1 steps (hidden, logits and every cache row)
    and the JAX package's step under ``jax.vmap``."""
    jm, tm = models
    stack = tm.config.talker.layer_stack()
    rs = np.random.RandomState(0)
    pos = [5, 11, 8]
    rows = 24
    cache_np = [rs.randn(stack.num_layers, 1, rows, stack.num_kv_heads, stack.head_dim).astype(np.float32) * 0.5
                for _ in pos]
    x_np = rs.randn(len(pos), 1, 1, TINY_TALKER.hidden_size).astype(np.float32)

    batch_cache = tnn.KVCache(torch.from_numpy(np.concatenate(cache_np, 1)),
                              torch.from_numpy(np.concatenate(cache_np, 1) * 0.7))
    with torch.no_grad():
        h, logits = ttalker.decode_step_batch(tm.talker_params, tm.config.talker, torch.from_numpy(x_np[:, 0]),
                                              torch.tensor(pos), batch_cache)
        for b, p in enumerate(pos):
            solo = tnn.KVCache(torch.from_numpy(cache_np[b].copy()), torch.from_numpy(cache_np[b] * 0.7))
            hb, lb = ttalker.decode_step(tm.talker_params, tm.config.talker, torch.from_numpy(x_np[b]), p, solo)
            np.testing.assert_allclose(h[b:b + 1].numpy(), hb.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(logits[b:b + 1].numpy(), lb.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(batch_cache.k[:, b:b + 1].numpy(), solo.k.numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(batch_cache.v[:, b:b + 1].numpy(), solo.v.numpy(), rtol=0, atol=1e-6)

    def step(x, p, k, v):
        return jtalker.decode_step(jm.talker_params, jm.config.talker, x, p, jnn.KVCache(k, v))

    jh, jlogits, jcache = jax.vmap(step)(jnp.asarray(x_np), jnp.asarray(pos, jnp.int32),
                                         jnp.asarray(np.stack(cache_np)), jnp.asarray(np.stack(cache_np) * 0.7))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh)[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(batch_cache.k.numpy(), np.concatenate(list(np.asarray(jcache.k)), 1), rtol=0,
                               atol=1e-5)


@TEMPERATURES
def test_sampling_rows_are_independent(temperature):
    """Penalties with a per-stream mask [B, V] and ``sample`` with a
    per-stream uniform [B]: each row's token is that row's alone, and the
    JAX package's for the row."""
    from qwen3_tts_tpu.ops import sampling as jsampling
    from qwen3_tts_tpu_torch.ops import sampling as tsampling

    rs = np.random.RandomState(4)
    b, vocab = 6, 3072
    logits = (rs.randn(b, vocab) * 3).astype(np.float32)
    mask = (rs.rand(b, vocab) < 0.05).astype(np.float32)
    uniforms = rs.rand(b).astype(np.float32)
    cfg = tsampling.SamplingConfig(temperature=temperature, repetition_penalty=1.5, min_new_tokens=4)
    jcfg = jsampling.SamplingConfig(temperature=temperature, repetition_penalty=1.5, min_new_tokens=4)
    supp = tsampling.build_suppression_mask(vocab, cfg.eos_token_id)
    jsupp = jsampling.build_suppression_mask(vocab, jcfg.eos_token_id)
    for count in (2, 7):
        pen = tsampling.apply_generation_penalties(torch.from_numpy(logits), torch.from_numpy(mask), supp, cfg, count)
        tokens = tsampling.sample(pen, cfg, torch.from_numpy(uniforms))
        for i in range(b):
            row = tsampling.apply_generation_penalties(torch.from_numpy(logits[i:i + 1]), torch.from_numpy(mask[i]),
                                                       supp, cfg, count)
            torch.testing.assert_close(pen[i:i + 1], row, rtol=0, atol=0)
            assert int(tsampling.sample(row, cfg, torch.tensor(uniforms[i]))[0]) == int(tokens[i])
            jrow = jsampling.apply_generation_penalties(jnp.asarray(logits[i:i + 1]), jnp.asarray(mask[i]), jsupp,
                                                        jcfg, jnp.int32(count))
            assert int(jsampling.sample(jrow, jcfg, jnp.float32(uniforms[i]))[0]) == int(tokens[i])


@pytest.mark.parametrize("b,m", [(8, 1), (8, 10), (3, 17)])
def test_int8_matmul_batch_rule(b, m):
    """``int8_matmul`` on [B, m, K] is B plain calls on [m, K]: the batch
    folds into rows against one weight."""
    rs = np.random.RandomState(b * 100 + m)
    w = quant.quantize_linear(torch.from_numpy(rs.randn(256, 384).astype(np.float32)))
    x = torch.from_numpy(rs.randn(b, m, 256).astype(np.float32)).to(torch.bfloat16)
    got = quant.int8_matmul(x, w["q8"], w["scale"])
    assert got.shape == (b, m, 384) and got.dtype == torch.bfloat16
    for i in range(b):
        torch.testing.assert_close(got[i], quant.int8_matmul_plain(x[i], w["q8"], w["scale"]), rtol=0, atol=0)


@pytest.mark.parametrize("b,m,k,n,route", [
    (8, 1, 2048, 4096, "kernel"),  # the talker's qkv at a batch-8 decode step
    (8, 10, 2048, 12288, "kernel"),  # batch-8 CustomVoice prefill: 80 rows
    (8, 128, 2048, 2048, "kernel"),  # 1024 rows, the gate's edge
    (8, 129, 2048, 2048, "plain"),  # 1032 rows
    (4, 300, 6144, 2048, "plain"),
    (8, 1, 2048, 3000, "plain"),  # N not a multiple of 128
])
def test_int8_matmul_route_on_meta(b, m, k, n, route):
    """The route by the JAX package's gate on the folded rows, from shapes
    alone; per-example weights raise."""
    x = torch.empty((b, m, k), device="meta")
    q8 = torch.empty((k, n), dtype=torch.int8, device="meta")
    assert quant.int8_matmul_route(x, q8) == route
    with pytest.raises(ValueError, match="per-example"):
        quant.int8_matmul_route(x, torch.empty((b, k, n), dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="per-example"):
        quant.int8_matmul(x, torch.empty((b, k, n), dtype=torch.int8, device="meta"), torch.empty((b, n)))
