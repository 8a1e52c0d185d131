"""Multi-GPU serving, the port against the JAX package (CPU).

The port's mesh is of CPU ranks (``make_mesh(["cpu"] * n)``: ranks that
share the CPU add their partial sums locally), the JAX package's the 8
virtual CPU devices of ``tests/conftest.py``. On the same inputs:

* ``make_mesh`` gives the JAX package's (dp, tp) for 1-8 devices, defaults
  and explicit tp, and both raise on a tp that does not fit;
* the port's specs split the axes the JAX ``PartitionSpec``s name, leaf for
  leaf, for unfused, fused and int8 talker trees (a fused leaf's blocks are
  its q / k / v or gate / up widths);
* ``_tp_block_perm`` and ``make_tp_pack`` equal the JAX package's, the pack
  bit for bit on the same int8 tree, and None where the JAX one is;
* ``tp_decode_step`` at tp = 2 and 4 (8 q / 4 KV heads of 16: unequal q and
  kv widths) gives the JAX ``tp_decode_step`` under ``shard_map`` (its
  kernels in interpret mode) and the port's unsharded step within 1e-5 of
  max|JAX| (f32; partial sums in another order), the written cache rows
  too, every other row unchanged;
* the facade at dp = 2 x tp = 2 (``Qwen3TTS.shard``), f32 and int8, staged
  and streamed: frames token-exact to the JAX package's sharded model and
  to the port unsharded, audio within 1e-6 (f32) and 1e-5 (int8) of the
  JAX package's (its own bars for sharded against unsharded) and bit-equal
  to the port unsharded's. The int8 run takes kernels 5 and 6 per rank
  (``tp_decode_step``) and holds no kernel-3 pack.
* ``synthesize_batch`` of 4 under dp = 2 (two streams a replica) against
  the JAX package's sharded batch, and ``synthesize_streaming_batch``;
* the talker's text projection, prefill and codec head on a tp = 2 tree
  against the unsharded tree.

Each JAX sharded model is built once for the file (the ``jax_sharded``
fixture); ``tests/test_torch_parallel.py`` holds the port's own checks.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.config import ModelType
from qwen3_tts_tpu.models.config import TalkerConfig as JTalkerConfig
from qwen3_tts_tpu.ops import fused_layer as jfl
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu.parallel import sharding as JS
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.ops import fused_layer as tfl
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.parallel import sharding as S
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_torch_voice_clone import build_models

torch.set_num_threads(1)

OPTS = dict(max_length=6, seed=42, temperature=0.001)
TEXT = "shard me"
# 8 q / 4 KV heads of 16: tp = 2 and 4 both divide, and a contiguous chunk
# of the fused [q|k|v] (128 | 64 | 64) would hold the wrong heads.
STEP_CFG = JTalkerConfig(text_embed_dim=32, hidden_size=64, text_proj_intermediate=32, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4, head_dim=16)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(jtree, ttree, path=""):
    """Pairs of (JAX leaf, port leaf) of two trees of the same structure."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            yield from _walk(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    devs = jax.devices()[:n]
    for tp in (None, 1, n):
        assert S.make_mesh(["cpu"] * n, tp=tp).shape == dict(JS.make_mesh(devs, tp=tp).shape)
    bad = n + 1
    with pytest.raises(ValueError):
        JS.make_mesh(devs, tp=bad)
    with pytest.raises(ValueError):
        S.make_mesh(["cpu"] * n, tp=bad)


@pytest.fixture(scope="module")
def trees():
    """(JAX, port) talker trees: unfused, fused, fused int8 (same values)."""
    jbase = jax.jit(JW.init_talker_params, static_argnums=(1, 2))(jax.random.PRNGKey(4), STEP_CFG, jnp.float32)
    jfused = JW.fuse_model_params(jbase)
    jint8 = jq.quantize_talker_params(jfused)
    return [(j, TW.from_numpy_tree(_numpy(j), "cpu")) for j in (jbase, jfused, jint8)]


def test_specs_match_jax(trees):
    """Leaf for leaf, the port's split axes are the JAX PartitionSpec's; a
    fused leaf carries its blocks."""
    for jtree, ttree in trees:
        jspecs = JS.talker_specs(STEP_CFG, jtree)
        tspecs = S.talker_specs(STEP_CFG, ttree)
        pairs = list(_walk(jspecs, tspecs))
        assert pairs
        for path, js, ts in pairs:
            assert tuple(ts) == tuple(js), path
            fused = "qkv_proj" in path or "gateup_proj" in path
            assert bool(ts.blocks) == fused, path
        if "qkv_proj" in ttree["layers"]:
            specs = tspecs["layers"]
            qkv = specs["qkv_proj"]["q8"] if "q8" in specs["qkv_proj"] else specs["qkv_proj"]
            assert qkv.blocks == (128, 64, 64)
    for name in ("serving_cache_spec",):
        assert tuple(getattr(S, name)()) == tuple(getattr(JS, name)())
    # The batched cache: streams on dp, KV heads on tp, in each package's layout.
    assert tuple(JS.batch_cache_spec()) == ("dp", None, None, None, "tp", None)
    assert tuple(S.batch_cache_spec()) == (None, "dp", None, "tp", None)
    assert tuple(S.tp_pack_specs()["qkv"]["scale"]) == tuple(JS.tp_pack_specs()["qkv"]["scale"])


def test_tp_block_perm_and_pack_match_jax(trees):
    for widths, tp in (((8, 4, 4), 2), ((128, 64, 64), 4), ((128, 128), 2)):
        np.testing.assert_array_equal(tfl._tp_block_perm(widths, tp), jfl._tp_block_perm(widths, tp))
    (jbase, tbase), (jfused, tfused), (jint8, tint8) = trees
    stack_j, stack_t = STEP_CFG.layer_stack(), tnn.LayerStackConfig(**vars(STEP_CFG.layer_stack()))
    for tp in (2, 4):
        jpack = jfl.make_tp_pack(jint8["layers"], stack_j, tp)
        tpack = tfl.make_tp_pack(tint8["layers"], stack_t, tp)
        for path, a, b in _walk(_numpy(jpack), tpack):
            assert b.numpy().dtype == np.asarray(a).dtype, path
            np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
        # A rank's chunk of the pack is its block slice of the fused tree.
        ranks = S.shard_pytree(tint8["layers"], S.layer_stack_specs(tint8["layers"]), S.make_mesh(["cpu"] * tp))
        for t, rank in enumerate(ranks[0]):
            chunk = S.shard_leaf(tpack["qkv"]["q8"], S.P(None, None, "tp"), S.make_mesh(["cpu"] * tp))[0][t]
            assert torch.equal(rank["qkv_proj"]["q8"], chunk)
    for tp in (3, 8):  # tp does not divide the KV heads
        assert jfl.make_tp_pack(jint8["layers"], stack_j, tp) is None
        assert tfl.make_tp_pack(tint8["layers"], stack_t, tp) is None
    for jt, tt in ((jbase, tbase), (jfused, tfused)):  # not fused int8
        assert jfl.make_tp_pack(jt["layers"], stack_j, 2) is None
        assert tfl.make_tp_pack(tt["layers"], stack_t, 2) is None


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_step_matches_jax_and_unsharded(trees, tp):
    _, _, (jint8, tint8) = trees
    stack_j, stack_t = STEP_CFG.layer_stack(), tnn.LayerStackConfig(**vars(STEP_CFG.layer_stack()))
    L, H, kvd, rows, pos = 2, 64, 64, 40, 29
    rs = np.random.RandomState(tp)
    x = rs.randn(1, 1, H).astype(np.float32)
    ck0 = rs.randn(L, rows, kvd).astype(np.float32)
    cv0 = rs.randn(L, rows, kvd).astype(np.float32)

    jmesh = JS.make_mesh(jax.devices()[:tp], tp=tp)
    jpack = jfl.make_tp_pack(jint8["layers"], stack_j, tp)
    inv = jnn.rope_inv_freq(stack_j.head_dim, stack_j.rope_theta)
    cos_row, sin_row = jnn.rope_cos_sin(jnp.float32(pos)[None], inv)
    step = jax.jit(jfl.tp_decode_step, static_argnames=("cfg", "mesh"))
    jy, jck, jcv = step(jint8["layers"], jpack, jnp.asarray(x), cfg=stack_j, cache_k=jnp.asarray(ck0),
                        cache_v=jnp.asarray(cv0), pos=jnp.int32(pos), cos_row=cos_row, sin_row=sin_row, mesh=jmesh)

    mesh = S.make_mesh(["cpu"] * tp)
    layers = tint8["layers"]
    rank_layers = S.shard_pytree(layers, S.layer_stack_specs(layers), mesh)[0]
    rank_packs = S.shard_pytree(tfl.make_tp_pack(layers, stack_t, tp), S.tp_pack_specs(), mesh)[0]
    plane = S.P(None, None, "tp")
    cks = S.shard_leaf(torch.from_numpy(ck0), plane, mesh)[0]
    cvs = S.shard_leaf(torch.from_numpy(cv0), plane, mesh)[0]
    ty = tfl.tp_decode_step(rank_layers, rank_packs, torch.from_numpy(x), stack_t, cks, cvs, pos, mesh.replica(0))
    _close(ty, jy, "tp step against JAX")
    ck_tp, cv_tp = torch.cat(cks, dim=-1), torch.cat(cvs, dim=-1)
    _close(ck_tp[:, pos], np.asarray(jck)[:, pos], "written k rows")
    _close(cv_tp[:, pos], np.asarray(jcv)[:, pos], "written v rows")
    others = torch.arange(rows) != pos
    assert torch.equal(ck_tp[:, others], torch.from_numpy(ck0)[:, others])
    assert torch.equal(cv_tp[:, others], torch.from_numpy(cv0)[:, others])

    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    cos_t, sin_t = tfl.rope_tables(16, stack_t.rope_theta, rows, torch.device("cpu"))
    want = tfl.run_fused_decode_step(layers, torch.from_numpy(x), stack_t, ck, cv, pos, cos_t, sin_t, streamed=False)
    _close(ty, want.numpy(), "tp step against the unsharded step")
    _close(ck_tp[:, pos], ck[:, pos].numpy(), "written k rows against the unsharded step")
    _close(cv_tp[:, pos], cv[:, pos].numpy(), "written v rows against the unsharded step")


# ---------------------------------------------------------------------------
# The facade at dp = 2 x tp = 2
# ---------------------------------------------------------------------------


def _jax_model(jm, **kw):
    return JP.Qwen3TTS(jm.config, jm.talker_params, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                       vocoder_config=jm.vocoder_config, **kw)


def _port_model(tm, **kw):
    return Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                    vocoder_config=tm.vocoder_config, **kw)


@pytest.fixture(scope="module")
def models():
    return build_models(ModelType.CUSTOM_VOICE)


@pytest.fixture(scope="module")
def jax_sharded(models):
    """The JAX package's f32 and int8 models at dp = 2 x tp = 2, each built
    and sharded once for the file (by ``int8``)."""
    jm, _ = models
    built = {}

    def get(int8: bool):
        if int8 not in built:
            kw = {"quantize_int8": True} if int8 else {}
            built[int8] = _jax_model(jm, **kw).shard(JS.make_mesh(jax.devices()[:4], tp=2))
        return built[int8]

    return get


def _runs(model, opts_cls):
    """(staged audio, staged frames, streamed frames, next_chunk audio) of ``TEXT``."""
    opts = opts_cls(**OPTS)
    session = model._custom_voice_session(TEXT, "ryan", "english", opts)
    frames = session.run_to_completion()
    audio = model.decode_codes(frames).samples
    streamed = model.synthesize_streaming(TEXT, "ryan", "english", opts).run_to_completion()
    chunks = [c.samples for c in model.synthesize_streaming(TEXT, "ryan", "english", replace(opts, chunk_frames=3))]
    return audio, frames, streamed, np.concatenate(chunks)


@pytest.mark.parametrize("int8", [False, True])
def test_facade_matches_jax_sharded(models, jax_sharded, int8, monkeypatch):
    _, tm = models
    kw = {"quantize_int8": True} if int8 else {}
    jsh = jax_sharded(int8)
    j_audio, _ = jsh.synthesize_with_timing(TEXT, "ryan", "english", JP.SynthesisOptions(**OPTS))
    j_frames = jsh.synthesize_streaming(TEXT, "ryan", "english", JP.SynthesisOptions(**OPTS)).run_to_completion()

    steps = []
    routed = tfl.tp_decode_step
    monkeypatch.setattr(tfl, "tp_decode_step", lambda *a, **k: steps.append(1) or routed(*a, **k))
    mesh = S.make_mesh(["cpu"] * 4, tp=2)
    sh = _port_model(tm, **kw).shard(mesh)
    assert sh.mesh is mesh and isinstance(sh.talker_params, S.ShardedTree)
    assert sh.talker_step_pack is None
    assert ("tp_pack" in sh.talker_params) == int8
    audio, frames, streamed, chunked = _runs(sh, SynthesisOptions)
    assert (len(steps) > 0) == int8  # the int8 talker's steps take kernels 5 + 6 per rank

    ref_audio, ref_frames, ref_streamed, ref_chunked = _runs(_port_model(tm, **kw), SynthesisOptions)
    np.testing.assert_array_equal(frames, j_frames)
    np.testing.assert_array_equal(streamed, j_frames)
    np.testing.assert_array_equal(frames, ref_frames)
    np.testing.assert_array_equal(streamed, ref_streamed)
    np.testing.assert_allclose(audio, j_audio.samples, rtol=0, atol=1e-5 if int8 else 1e-6)
    np.testing.assert_array_equal(audio, ref_audio)
    np.testing.assert_array_equal(chunked, ref_chunked)


BATCH_TEXTS = ["alpha", "beta gamma", "delta", "epsilon zeta eta"]


def test_batch_dp_matches_jax_sharded(models, jax_sharded):
    """Four streams at dp = 2 x tp = 2 (two a replica, one prompt padding):
    each stream's frames and audio are the JAX sharded batch's; the
    streamed batch gives each stream the same audio chunk by chunk."""
    _, tm = models
    jsh = jax_sharded(False)
    opts = dict(max_length=4, seed=11, temperature=0.001)
    j_audio = jsh.synthesize_batch(BATCH_TEXTS, options=JP.SynthesisOptions(**opts))

    sh = _port_model(tm).shard(S.make_mesh(["cpu"] * 4, tp=2))
    group = sh._prepare_batch_group("basic", BATCH_TEXTS, ["ryan"] * 4, ["english"] * 4, [None] * 4,
                                    SynthesisOptions(**opts), [11, 12, 13, 14])
    assert [g.replica for g in group.shards] == [0, 1] and [g.batch for g in group.shards] == [2, 2]
    assert all(isinstance(g.state.cache, tnn.TPCache) for g in group.shards)
    frames, counts = sh._generate_batch_group(group)
    j_frames, j_counts, _ = jsh._generate_batch_group(
        "basic", BATCH_TEXTS, ["ryan"] * 4, ["english"] * 4, [None] * 4,
        jsh._normalize_options(JP.SynthesisOptions(**opts)), [11, 12, 13, 14])
    np.testing.assert_array_equal(counts, j_counts)
    for f, j, n in zip(frames, j_frames, counts):
        np.testing.assert_array_equal(f[:n], j[:n])
    audio = sh.synthesize_batch(BATCH_TEXTS, options=SynthesisOptions(**opts))
    ref = _port_model(tm).synthesize_batch(BATCH_TEXTS, options=SynthesisOptions(**opts))
    for a, j, r in zip(audio, j_audio, ref):
        assert len(a.samples) == len(j.samples) == len(r.samples)
        np.testing.assert_allclose(a.samples, j.samples, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.samples, r.samples)

    parts = [[] for _ in BATCH_TEXTS]
    for chunks in sh.synthesize_streaming_batch(BATCH_TEXTS, options=SynthesisOptions(**opts, chunk_frames=3,
                                                                                       first_chunk_frames=2)):
        for i, c in enumerate(chunks):
            if c is not None:
                parts[i].append(c.samples)
    for p, r in zip(parts, ref):
        np.testing.assert_allclose(np.concatenate(p), r.samples, rtol=0, atol=1e-5 * np.abs(r.samples).max())


def test_talker_functions_on_a_sharded_tree(trees):
    """text_project, the prefill and codec_logits on a tp = 2 tree against
    the unsharded tree (f32: within 1e-5 of max|x|), the codec head's
    logits gathered on the first device."""
    _, (_, tfused), _ = trees
    mesh = S.make_mesh(["cpu"] * 2)
    ranks = S.shard_pytree(tfused, S.talker_specs(STEP_CFG, tfused), mesh)[0]
    sharded = S.ShardedTree(ranks, mesh.replica(0))
    cfg = STEP_CFG
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(3, cfg.text_embed_dim).astype(np.float32))
    _close(ttalker.text_project(sharded, x), ttalker.text_project(tfused, x).numpy(), "text projection")
    prompt = torch.from_numpy(rs.randn(2, 10, cfg.hidden_size).astype(np.float32))
    stack = tnn.LayerStackConfig(**vars(cfg.layer_stack()))
    cache = tnn.init_kv_cache(stack, 2, 24, torch.float32)
    tcache = tnn.TPCache(tuple(tnn.KVCache(k, v) for k, v in zip(
        S.shard_leaf(cache.k, S.batch_cache_spec(), mesh)[0], S.shard_leaf(cache.v, S.batch_cache_spec(), mesh)[0])))
    tcfg = ttalker.TalkerConfig(**{f: getattr(cfg, f) for f in ttalker.TalkerConfig.__dataclass_fields__})
    h_ref, l_ref = ttalker.prefill_batch(tfused, tcfg, prompt, [10, 7], cache)
    h_tp, l_tp = ttalker.prefill_batch(sharded, tcfg, prompt, [10, 7], tcache)
    _close(h_tp, h_ref.numpy(), "prefill hidden")
    _close(l_tp, l_ref.numpy(), "prefill logits")
    _close(torch.cat([p.k for p in tcache.parts], dim=3), cache.k.numpy(), "prefill cache rows")
