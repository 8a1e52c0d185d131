"""Multi-GPU serving, the port's own checks (CPU, and two cards where there are).

``tests/test_torch_parallel_jax.py`` holds the port against the JAX
package's sharded model; here, on meshes of CPU ranks:

* ``make_mesh`` takes every card by default and raises without one (no CPU
  fallback); a mesh that mixes the CPU and cards, or a tp group that is
  neither one device nor distinct cards, raises;
* placement: ranks that share a device share what it already holds
  (``shard_pytree``, ``replicate_pytree``);
* the local collectives: a sum in rank order in the parts' dtype (bf16 adds
  bf16), the same tensor for every rank of one device, each call counted by
  its route;
* ``nn.run_layer_stack_tp`` at tp = 2 and 4 against ``nn.run_layer_stack``
  on the same weights in every form (prefill, a step, per-stream
  positions, MRoPE streams, tiered decode attention, an int8 tree): f32
  within 1e-5 of max|x|, the cache rows too; the w8a8 row-parallel product
  bit for bit the one-device product;
* a sharded batch of 3 at dp = 2 (not a multiple: the JAX package's
  warning, every stream on replica 0) and a w8a8 batch of 2 under dp = 2,
  each stream's frames those of the model unsharded; a session whose
  buffers grow grows every rank's cache and keeps the unsharded frames; a
  cache above ``TALKER_STREAM_MAX_SEQ`` takes the tensor-parallel layer
  path;
* ``from_pretrained(dir, mesh=)`` equals ``shard`` after the load, rank for
  rank; sharding leaves a second, unsharded model's trees and routes as
  they were;
* the 1.7B int8 talker's shard widths at tp = 4 and 8 take kernel 4 and the
  kernel-5/6 plan.

On the card (``gpu``): NCCL's all-reduce across two cards against the
local sum (skips with fewer than two cards), and a second model's kernel
packs kept when another is sharded.
"""

import logging
from dataclasses import replace

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import ckpt_fixture, vocoder_fixture
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.codec.vocoder import VocoderConfig
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, TalkerConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer, nn, quant
from qwen3_tts_tpu_torch.parallel import collectives
from qwen3_tts_tpu_torch.parallel import sharding as S
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions

torch.set_num_threads(1)

# 8 q / 4 KV heads of 16 (q and kv widths unequal), intermediate 128.
TALKER = TalkerConfig(text_embed_dim=32, hidden_size=64, text_proj_intermediate=32, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4, head_dim=16)
CP = CodePredictorConfig(hidden_size=64, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, vocab_size=128)
VOC = VocoderConfig(codebook_dim=16, latent_dim=24, hidden_size=16, num_layers=2, num_heads=2, head_dim=8,
                    intermediate_size=32, codebook_size=2048, codebook_embed_dim=8, decoder_dim=32)
OPTS = SynthesisOptions(max_length=6, seed=42, temperature=0.001)
STACK = TALKER.layer_stack()


class CharTokenizer:
    def encode(self, text: str) -> list[int]:
        return [3 + ord(c) % 50 for c in text[:12]] or [5]


def _config():
    return replace(config_for_variant("0.6B", "custom_voice"), talker=TALKER, code_predictor=CP)


@pytest.fixture(scope="module")
def trees():
    gen = torch.Generator().manual_seed(7)
    return (W.init_talker_params(gen, TALKER, torch.float32), W.init_code_predictor_params(gen, CP, torch.float32),
            W.from_numpy_tree(vocoder_fixture.numpy_params(VOC, seed=13), "cpu"))


def _model(trees, **kw) -> Qwen3TTS:
    talker, cp, voc = trees
    return Qwen3TTS(_config(), talker, cp, voc, CharTokenizer(), vocoder_config=VOC, **kw)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape, what
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), what


def _cpu_mesh(dp: int, tp: int) -> S.Mesh:
    return S.make_mesh(["cpu"] * (dp * tp), tp=tp)


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_mesh()
    with pytest.raises(RuntimeError):
        S.make_mesh(["cuda:0", "cuda:1"])
    mesh = S.make_mesh(["cpu"] * 6, tp=2)
    assert mesh.shape == {"dp": 3, "tp": 2} and mesh.first(2) == torch.device("cpu")
    with pytest.raises(ValueError):
        S.make_mesh(["cpu"] * 6, tp=4)


def test_mesh_refuses_mixed_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = S.make_mesh()  # every card: tp 4
    assert mesh.shape == {"dp": 1, "tp": 4} and mesh.replica(0) == [torch.device("cuda", i) for i in range(4)]
    assert S.make_mesh(["cuda:0"] * 4, tp=2).shape == {"dp": 2, "tp": 2}  # ranks sharing one card
    # dp = 3 x tp = 2 over two cards: each replica's ranks are distinct cards.
    assert S.make_mesh(["cuda:0", "cuda:1"] * 3, tp=2).shape == {"dp": 3, "tp": 2}
    with pytest.raises(ValueError, match="mixes device types"):
        S.make_mesh(["cpu", "cuda:0"], tp=1)
    with pytest.raises(ValueError, match="neither all one device"):
        S.make_mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:2"], tp=4)
    with pytest.raises(ValueError, match="no CUDA device 4"):
        S.make_mesh(["cuda:4"])
    assert collectives.route(["cuda:0", "cuda:1"]) == "nccl" and collectives.route(["cpu"] * 3) == "local"


def test_local_collectives():
    collectives.counts.clear()
    rs = np.random.RandomState(0)
    parts = [torch.from_numpy(rs.randn(5, 7).astype(np.float32)).to(torch.bfloat16) for _ in range(3)]
    out = collectives.all_reduce(parts)
    assert len(out) == 3 and out[0] is out[1] is out[2] and out[0].dtype == torch.bfloat16
    assert torch.equal(out[0], (parts[0] + parts[1]) + parts[2])  # rank order, bf16 adds
    assert torch.equal(collectives.all_reduce(parts, "max")[0], torch.maximum(torch.maximum(parts[0], parts[1]),
                                                                              parts[2]))
    x = parts[0]
    assert all(t is x for t in collectives.broadcast(x, [torch.device("cpu")] * 3))
    assert torch.equal(collectives.gather(parts, torch.device("cpu")), torch.cat(parts, dim=-1))
    assert dict(collectives.counts) == {("all_reduce", "local"): 2, ("broadcast", "local"): 1,
                                        ("gather", "local"): 1}


def test_placement_shares_what_a_device_already_holds(trees):
    """Ranks that share a device and a piece share one tensor; a whole leaf
    is not copied onto the device that holds it; a split leaf is copied (so
    the unsharded tree can be freed)."""
    talker, _, voc = trees
    mesh = _cpu_mesh(2, 2)
    ranks = S.shard_pytree(talker, S.talker_specs(TALKER, talker), mesh)
    for t in range(2):
        assert ranks[0][t]["layers"]["q_proj"] is ranks[1][t]["layers"]["q_proj"]
        assert ranks[0][t]["text_embedding"] is talker["text_embedding"]
        assert ranks[0][t]["layers"]["o_proj"].shape == (2, 64, 64)
        assert ranks[0][t]["layers"]["o_proj"].untyped_storage().data_ptr() != \
            talker["layers"]["o_proj"].untyped_storage().data_ptr()
    whole = S.replicate_pytree(voc, mesh)
    assert len(whole) == 2 and all(len(row) == 2 for row in whole)
    assert all(tree is whole[0][0] for row in whole for tree in row)
    _assert_trees_equal(whole[1][1], voc)


def _rank_caches(cache: nn.KVCache, spec, mesh: S.Mesh) -> list[nn.KVCache]:
    k, v = S.shard_leaf(cache.k, spec, mesh)[0], S.shard_leaf(cache.v, spec, mesh)[0]
    return [nn.KVCache(a, b) for a, b in zip(k, v)]


def _stack_case(layers: dict, tp: int, cfg: nn.LayerStackConfig, x, positions, write_pos, rows: int, batch: int,
                **kw) -> None:
    """run_layer_stack_tp against run_layer_stack from the same cache."""
    gen = torch.Generator().manual_seed(1)
    cache = nn.KVCache(*(torch.randn((cfg.num_layers, batch, rows, cfg.num_kv_heads, cfg.head_dim), generator=gen)
                         for _ in range(2)))
    mesh = _cpu_mesh(1, tp)
    caches = _rank_caches(cache, S.serving_cache_spec(), mesh)
    ranks = S.shard_pytree(layers, S.layer_stack_specs(layers), mesh)[0]
    want = nn.run_layer_stack(layers, x, cfg, cache, positions, write_pos, **kw)
    got = nn.run_layer_stack_tp(ranks, mesh.replica(0), x, cfg, caches, positions, write_pos, **kw)
    _close(got, want, "hidden")
    _close(torch.cat([c.k for c in caches], dim=3), cache.k, "cache k")
    _close(torch.cat([c.v for c in caches], dim=3), cache.v, "cache v")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", ["unfused", "fused", "int8"])
def test_layer_stack_tp_matches_one_device(trees, tp, tree):
    layers = trees[0]["layers"]
    if tree != "unfused":
        layers = W.fuse_layer_params(layers)
    if tree == "int8":
        layers = quant.quantize_layer_stack(layers)
    gen = torch.Generator().manual_seed(2)
    x10 = torch.randn((1, 10, 64), generator=gen)
    _stack_case(layers, tp, STACK, x10, torch.arange(10), 0, 24, 1, self_attn_prefill=True)  # prefill
    _stack_case(layers, tp, STACK, x10[:, :1], torch.tensor([13]), 13, 24, 1)  # a step
    pos = torch.tensor([3, 17, 9])
    _stack_case(layers, tp, STACK, torch.randn((3, 1, 64), generator=gen), pos[:, None], pos, 24, 3)  # per stream
    mrope = replace(STACK, mrope_section=(2, 3, 3))
    thw = torch.stack([torch.arange(10), torch.arange(10) // 2, torch.arange(10) % 3])
    _stack_case(layers, tp, mrope, x10, None, 0, 24, 1, positions_thw=thw, self_attn_prefill=True)  # MRoPE
    tiered = replace(STACK, decode_tiering=True)
    _stack_case(layers, tp, tiered, x10[:, :1], torch.tensor([300]), 300, 600, 1)  # a 512-row window


def test_row_parallel_w8a8_is_the_one_device_product():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 128), generator=gen)
    w = quant.quantize_linear(torch.randn((128, 48), generator=gen) * 0.05)
    with quant.w8a8_scope(True):
        want = quant.mm(x, w)
        xs = list(x.split(32, dim=-1))
        ws = [{"q8": q, "scale": w["scale"]} for q in w["q8"].split(32, dim=0)]
        got = nn.row_parallel(xs, ws, [torch.device("cpu")] * 4)
    assert torch.equal(got[0], want)


def _frames(model, text="shard me", options=OPTS):
    return model._custom_voice_session(text, "ryan", "english", options).run_to_completion()


def test_batch_not_divisible_by_dp_runs_on_replica_0(trees, caplog):
    texts = ["alpha", "beta gamma", "delta"]
    ref = _model(trees)
    sh = _model(trees).shard(_cpu_mesh(2, 2))
    with caplog.at_level(logging.WARNING, logger="qwen3_tts_tpu_torch"):
        group = sh._prepare_batch_group("basic", texts, ["ryan"] * 3, ["english"] * 3, [None] * 3, OPTS, [1, 2, 3])
    assert "not divisible by dp=2" in caplog.text
    assert group.parts is None and group.replica == 0 and isinstance(group.state.cache, nn.TPCache)
    frames, counts = sh._generate_batch_group(group)
    want, want_counts = ref._generate_batch_group(
        ref._prepare_batch_group("basic", texts, ["ryan"] * 3, ["english"] * 3, [None] * 3, OPTS, [1, 2, 3]))
    np.testing.assert_array_equal(counts, want_counts)
    for f, g in zip(frames, want):
        np.testing.assert_array_equal(f, g)


def test_w8a8_batch_under_dp(trees):
    texts = ["alpha", "beta gamma"]
    opts = replace(OPTS, max_length=4, seed=17)
    ref = _model(trees, quantize_int8=True, int8_activations=True)
    sh = _model(trees, quantize_int8=True, int8_activations=True).shard(_cpu_mesh(2, 2))
    assert sh.w8a8 and "tp_pack" in sh.talker_params
    group = sh._prepare_batch_group("basic", texts, ["ryan"] * 2, ["english"] * 2, [None] * 2, opts, [17, 18])
    assert [g.replica for g in group.shards] == [0, 1]
    frames, _ = sh._generate_batch_group(group)
    want, _ = ref._generate_batch_group(
        ref._prepare_batch_group("basic", texts, ["ryan"] * 2, ["english"] * 2, [None] * 2, opts, [17, 18]))
    for f, g in zip(frames, want):
        np.testing.assert_array_equal(f, g)
    audio, ref_audio = sh.synthesize_batch(texts, options=opts), ref.synthesize_batch(texts, options=opts)
    for a, b in zip(audio, ref_audio):
        np.testing.assert_allclose(a.samples, b.samples, rtol=0, atol=1e-5)


def test_growing_session_grows_every_rank(trees):
    sh = _model(trees, quantize_int8=True).shard(_cpu_mesh(1, 2))
    opts = replace(OPTS, max_length=300, min_new_tokens=6)
    session = sh._custom_voice_session("grow me", "ryan", "english", opts)
    rows = session.state.cache.max_seq
    session._advance_managed(4)
    session._grow(512)
    grown = session.state.cache
    assert isinstance(grown, nn.TPCache) and grown.max_seq == rows + 256
    assert all(p.k.shape == (2, 1, rows + 256, 2, 16) for p in grown.parts)
    assert ttalker.tp_plane_mode(sh.talker_params, sh.config.talker, grown, sh.mesh)
    session._advance_managed(6)
    ref = _model(trees, quantize_int8=True)._custom_voice_session("grow me", "ryan", "english", opts)
    ref._advance_managed(6)
    np.testing.assert_array_equal(session.state.frames[:6].numpy(), ref.state.frames[:6].numpy())
    big = sh._place_cache(nn.init_kv_cache(STACK, 1, fused_layer.TALKER_STREAM_MAX_SEQ + 16, torch.float32))
    assert not ttalker.tp_plane_mode(sh.talker_params, sh.config.talker, big, sh.mesh)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ckpt")
    cfg = _config()
    ckpt_fixture.write_checkpoint(root, cfg, ckpt_fixture.seeded_weights(ckpt_fixture.model_specs(cfg), 5),
                                  ckpt_fixture.seeded_weights(ckpt_fixture.speech_specs(VOC), 6, torch.float32), VOC)
    return root


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.device == want.device and torch.equal(got, want), path
    else:
        assert got == want, path


def test_from_pretrained_mesh_equals_shard_after_load(ckpt):
    mesh = _cpu_mesh(2, 2)
    loaded = Qwen3TTS.from_pretrained(ckpt, dtype=torch.float32, device="cpu", quantize_int8=True, mesh=mesh)
    sharded = Qwen3TTS.from_pretrained(ckpt, dtype=torch.float32, device="cpu", quantize_int8=True).shard(mesh)
    assert loaded.mesh is mesh and len(loaded.replicas) == 2
    for a, b in zip(loaded.replicas, sharded.replicas):
        _assert_trees_equal(a.talker_params.ranks, b.talker_params.ranks)
        _assert_trees_equal(a.cp_params, b.cp_params)
    _assert_trees_equal(loaded.vocoder_params, sharded.vocoder_params)
    np.testing.assert_array_equal(_frames(loaded), _frames(sharded))
    with pytest.raises(RuntimeError, match="already sharded"):
        loaded.shard(mesh)


def test_second_model_keeps_its_trees_and_routes(trees):
    first = _model(trees, quantize_int8=True)
    before = _frames(first)
    sh = _model(trees, quantize_int8=True).shard(_cpu_mesh(2, 2))
    second = _model(trees, quantize_int8=True)
    for m in (first, second):
        assert m.mesh is None and isinstance(m.talker_params, dict) and not m.replicas
        session = m._custom_voice_session("shard me", "ryan", "english", OPTS)
        assert ttalker.stream_plane_mode(m.talker_params, m.config.talker, session.state.cache)
        np.testing.assert_array_equal(session.run_to_completion(), before)
    assert isinstance(sh.talker_params, S.ShardedTree) and not quant._w8a8_allowed()
    np.testing.assert_array_equal(_frames(sh), before)


@pytest.mark.parametrize("tp", [4, 8])
def test_1p7b_int8_shard_widths_take_kernels_4_5_6(tp):
    """The 1.7B talker's rank slices (tp = 4: o K 512, down K 1536, qkv N
    1024, gate|up N 3072, codec head N 768) are multiples of 128 for kernel
    4, and the rank-local stack takes kernels 5 and 6's plan at every
    generation tier's rows."""
    tcfg = config_for_variant("1.7B", "custom_voice").talker
    local = nn.tp_local_config(tcfg.layer_stack(), tp)
    h, d = tcfg.hidden_size, tcfg.head_dim
    qd, kvd, inter = local.num_heads * d, local.num_kv_heads * d, local.intermediate_size
    shapes = [(qd, h), (inter, h), (h, qd + 2 * kvd), (h, 2 * inter), (h, tcfg.codec_vocab_size // tp)]
    if tp == 4:
        assert shapes == [(512, 2048), (1536, 2048), (2048, 1024), (2048, 3072), (2048, 768)]
    for k, n in shapes:
        for m in (1, 10, 80):
            x = torch.empty((m, k), device="meta")
            assert quant.int8_matmul_route(x, torch.empty((k, n), dtype=torch.int8, device="meta")) == "kernel"
    for dtype in (torch.bfloat16, torch.float32):
        fused_layer.fused_step_plan(local, dtype, 132, fused_layer.TALKER_STREAM_MAX_SEQ)


def _cards(n: int) -> list[torch.device]:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.gpu
def test_nccl_all_reduce_across_two_cards():
    devs = _cards(2)
    collectives.connect(devs)
    collectives.counts.clear()
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        host = [torch.randn((3, 2048), generator=gen).to(dtype) for _ in devs]
        parts = [h.to(d) for h, d in zip(host, devs)]
        out = collectives.all_reduce(parts)
        want = host[0].float() + host[1].float()
        for o, d in zip(out, devs):
            assert o.device == d
            tol = 0 if dtype == torch.float32 else 2.0**-7 * float(want.abs().max())
            assert float((o.cpu().float() - want).abs().max()) <= tol
    assert collectives.counts[("all_reduce", "nccl")] == 2
    whole = collectives.gather([torch.full((2, 4), float(i), device=d) for i, d in enumerate(devs)], devs[0])
    assert whole.device == devs[0] and torch.equal(whole.cpu(), torch.cat([torch.zeros(2, 4), torch.ones(2, 4)], 1))


@pytest.mark.gpu
def test_second_model_keeps_its_packs_on_the_card(trees):
    dev = _cards(1)[0]
    talker, cp, voc = (S.place_pytree(t, dev) for t in trees)
    first = Qwen3TTS(_config(), talker, cp, voc, CharTokenizer(), vocoder_config=VOC, quantize_int8=True)
    packs = (first.cp_frame_pack, first.talker_step_pack)
    sh = Qwen3TTS(_config(), talker, cp, voc, CharTokenizer(), vocoder_config=VOC,
                  quantize_int8=True).shard(S.make_mesh([dev] * 2, tp=2))
    second = Qwen3TTS(_config(), talker, cp, voc, CharTokenizer(), vocoder_config=VOC, quantize_int8=True)
    assert packs[0] is not None and packs[1] is not None
    assert (first.cp_frame_pack, first.talker_step_pack) == packs
    assert second.cp_frame_pack is not None and second.talker_step_pack is not None
    assert sh.talker_step_pack is None and sh.cp_frame_pack is not None and len(sh.tp_step_packs) == 2
    assert sh.tp_step_packs[0] is not sh.tp_step_packs[1]

