"""The port's talker decode step against the JAX package's, in both forms
of the JAX kernel: int8 weights and plain weights.

``talker_step_plain`` (what ``fused_layer.talker_step`` runs on a CPU
tensor) is held against JAX ``talker.decode_step`` on a stream-packed tree,
which runs the interpret-mode Pallas kernel ``streamed_talker_step``, on the
three cache cases of ``tests/test_fused_layer.py``
(``test_streamed_talker_step_matches_xla``). Int8, with that test's
tolerances: the same logits argmax, hidden and the whole cache within
rtol/atol 0.03 (bf16: the two kernels sum in other orders and the JAX
kernel rounds q to bf16 for its scores, so a written row may move by about
one bf16 ulp); in f32 the step is also held against the JAX package's
pack-free int8 layer scan, which rounds at the same points, within 1e-4.
Plain weights (the JAX plain pack, ``quantized=False``): f32 within 1e-5
(``tests/test_fused_layer.py::test_bf16_stream_pack_talker_step_matches_xla``'s
bar: only f32 summation order differs), and also against the pack-free XLA
layer scan within 1e-5; bf16 within 0.03 (sums in another order move a
bf16 rounding by an ulp); the same argmax in both. Rows other than ``pos``
must be untouched. The CUDA kernel is held against the plain version on
the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import talker as JT
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.models.config import TalkerConfig as JTalkerConfig
from qwen3_tts_tpu.ops import fused_layer as jfl
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu_torch.models import talker as TT
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.config import TalkerConfig
from qwen3_tts_tpu_torch.ops import fused_layer as tfl
from qwen3_tts_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

# tests/test_fused_layer.py's talker-step config (3 layers, H = 64).
JCFG = JTalkerConfig(
    text_embed_dim=32, hidden_size=64, text_proj_intermediate=32,
    intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16,
)
TCFG = TalkerConfig(**{f: getattr(JCFG, f) for f in TalkerConfig.__dataclass_fields__})


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


CACHE_CASES = [(24, 5), (32, 17), (288, 270)]


def _jax_fused_talker(seed, dtype=jnp.float32):
    return JW.fuse_model_params(JW.init_talker_params(jax.random.PRNGKey(seed), JCFG, dtype))


def _jax_int8_talker(seed):
    return jq.quantize_talker_params(_jax_fused_talker(seed))


def _with_pack(jparams, tile_dtype):
    jstream = dict(jparams)
    jstream["stream_pack"] = jfl.make_stream_pack(jparams["layers"], JCFG.layer_stack())
    assert jstream["stream_pack"] is not None and jstream["stream_pack"]["tiles"].dtype == tile_dtype
    return jstream


def _others_unchanged(after, before, pos):
    others = torch.ones(after.shape[2], dtype=torch.bool)
    others[pos] = False
    return torch.equal(after[:, :, others], before[:, :, others])


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("max_seq,pos", CACHE_CASES)
def test_plain_step_matches_jax_streamed_kernel(max_seq, pos):
    jparams = _jax_int8_talker(8)
    jstream = _with_pack(jparams, jnp.int8)

    rs = np.random.RandomState(4)
    shape = (3, 1, max_seq, 2, 16)
    k0 = rs.randn(*shape).astype(np.float32)
    v0 = rs.randn(*shape).astype(np.float32)
    x = rs.randn(1, 1, 64).astype(np.float32)
    jcache = jnn.KVCache(jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16))
    jh, jlogits, jcache = JT.decode_step(jstream, JCFG, jnp.asarray(x, jnp.bfloat16), jnp.int32(pos), jcache)

    tparams = TW.from_numpy_tree(_numpy(jparams), "cpu")
    tcache = tnn.KVCache(
        torch.from_numpy(k0).to(torch.bfloat16), torch.from_numpy(v0).to(torch.bfloat16)
    )
    k_before = tcache.k.clone()
    assert TT.stream_plane_mode(tparams, TCFG, tcache)
    before = tfl.talker_step.launches
    th, tlogits = TT.decode_step(tparams, TCFG, torch.from_numpy(x).to(torch.bfloat16), pos, tcache)
    assert tfl.talker_step.launches == before  # CPU tensors take the plain version
    assert th.dtype == torch.bfloat16 and th.shape == (1, 1, 64)

    assert int(torch.argmax(tlogits)) == int(jnp.argmax(jlogits))
    np.testing.assert_allclose(_to_np(th), np.asarray(jh, np.float32), rtol=0.03, atol=0.03)
    np.testing.assert_allclose(_to_np(tcache.k), np.asarray(jcache.k, np.float32), rtol=0.03, atol=0.03)
    np.testing.assert_allclose(_to_np(tcache.v), np.asarray(jcache.v, np.float32), rtol=0.03, atol=0.03)
    assert _others_unchanged(tcache.k, k_before, pos)


def test_plain_step_f32_matches_jax_layer_scan():
    """f32 activations and cache: the JAX package's pack-free int8 decode
    step (the XLA layer scan through quant.mm) rounds its matmul inputs to
    bf16 at the same points, so only f32 summation order differs: 1e-4."""
    jparams = _jax_int8_talker(9)
    rs = np.random.RandomState(5)
    shape = (3, 1, 32, 2, 16)
    k0 = rs.randn(*shape).astype(np.float32)
    v0 = rs.randn(*shape).astype(np.float32)
    x = rs.randn(1, 1, 64).astype(np.float32)
    pos = 20
    jh, jlogits, jcache = JT.decode_step(
        jparams, JCFG, jnp.asarray(x), jnp.int32(pos), jnn.KVCache(jnp.asarray(k0), jnp.asarray(v0))
    )
    tcache = tnn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    th, tlogits = TT.decode_step(TW.from_numpy_tree(_numpy(jparams), "cpu"), TCFG, torch.from_numpy(x), pos, tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=1e-4, atol=1e-4)


def _plain_inputs(max_seq, dtype, seed):
    """Random caches [3, 1, S, 2, 16] and x [1, 1, 64] from numpy (f32)."""
    rs = np.random.RandomState(seed)
    shape = (3, 1, max_seq, 2, 16)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32), rs.randn(1, 1, 64).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_seq,pos", CACHE_CASES)
def test_plain_weight_step_matches_jax_streamed_kernel(max_seq, pos, dtype):
    """Plain fused weights: ``talker_step_plain`` against the JAX plain-pack
    kernel (interpret mode). f32 within 1e-5, bf16 within 0.03, the same
    argmax; every row but ``pos`` bit-unchanged."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jparams = _jax_fused_talker(12, jdt)
    jstream = _with_pack(jparams, jdt)
    k0, v0, x = _plain_inputs(max_seq, dtype, 6)
    jcache = jnn.KVCache(jnp.asarray(k0, jdt), jnp.asarray(v0, jdt))
    jh, jlogits, jcache = JT.decode_step(jstream, JCFG, jnp.asarray(x, jdt), jnp.int32(pos), jcache)

    tparams = TW.from_numpy_tree(_numpy(jparams), "cpu")
    assert tparams["layers"]["qkv_proj"].dtype == tdt
    tcache = tnn.KVCache(torch.from_numpy(k0).to(tdt), torch.from_numpy(v0).to(tdt))
    k_before, v_before = tcache.k.clone(), tcache.v.clone()
    assert TT.stream_plane_mode(tparams, TCFG, tcache)
    before = tfl.talker_step.launches
    th, tlogits = TT.decode_step(tparams, TCFG, torch.from_numpy(x).to(tdt), pos, tcache)
    assert tfl.talker_step.launches == before  # CPU tensors take the plain version
    assert th.dtype == tdt and th.shape == (1, 1, 64)

    tol = 1e-5 if dtype == "float32" else 0.03
    assert int(torch.argmax(tlogits)) == int(jnp.argmax(jlogits))
    np.testing.assert_allclose(_to_np(th), np.asarray(jh, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(_to_np(tlogits), np.asarray(jlogits, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(_to_np(tcache.k), np.asarray(jcache.k, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(_to_np(tcache.v), np.asarray(jcache.v, np.float32), rtol=tol, atol=tol)
    assert _others_unchanged(tcache.k, k_before, pos) and _others_unchanged(tcache.v, v_before, pos)


@pytest.mark.parametrize("max_seq,pos", CACHE_CASES)
def test_plain_weight_step_f32_matches_jax_layer_scan(max_seq, pos):
    """Plain f32 fused weights against the JAX package's pack-free XLA layer
    scan (what its main path runs), within 1e-5 and the same argmax."""
    jparams = _jax_fused_talker(13)
    k0, v0, x = _plain_inputs(max_seq, "float32", 8)
    jh, jlogits, jcache = JT.decode_step(
        jparams, JCFG, jnp.asarray(x), jnp.int32(pos), jnn.KVCache(jnp.asarray(k0), jnp.asarray(v0))
    )
    tcache = tnn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    tparams = TW.from_numpy_tree(_numpy(jparams), "cpu")
    assert TT.stream_plane_mode(tparams, TCFG, tcache)
    th, tlogits = TT.decode_step(tparams, TCFG, torch.from_numpy(x), pos, tcache)
    assert int(torch.argmax(tlogits)) == int(jnp.argmax(jlogits))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=1e-5, atol=1e-5)


def test_stream_plane_mode_gate():
    """The JAX pack's gate, the fused tree standing for the pack: fused
    weights, all int8 or all plain, whose dims tile by H; a batch-1 cache;
    at most TALKER_STREAM_MAX_SEQ rows. Unfused and mixed trees are refused."""
    tparams = TW.from_numpy_tree(_numpy(_jax_int8_talker(10)), "cpu")
    stack = TCFG.layer_stack()

    def cache(batch, rows):
        return tnn.init_kv_cache(stack, batch, rows, torch.float32)

    assert TT.stream_plane_mode(tparams, TCFG, cache(1, 32))
    assert TT.stream_plane_mode(tparams, TCFG, cache(1, tfl.TALKER_STREAM_MAX_SEQ))
    assert not TT.stream_plane_mode(tparams, TCFG, cache(1, tfl.TALKER_STREAM_MAX_SEQ + 16))
    assert not TT.stream_plane_mode(tparams, TCFG, cache(2, 32))
    unfused = TW.from_numpy_tree(_numpy(JW.init_talker_params(jax.random.PRNGKey(10), JCFG)), "cpu")
    assert not TT.stream_plane_mode(unfused, TCFG, cache(1, 32))
    plain = TW.fuse_model_params(unfused)
    assert TT.stream_plane_mode(plain, TCFG, cache(1, 32))
    assert TT.stream_plane_mode(plain, TCFG, cache(1, tfl.TALKER_STREAM_MAX_SEQ))
    assert not TT.stream_plane_mode(plain, TCFG, cache(1, tfl.TALKER_STREAM_MAX_SEQ + 16))
    assert not TT.stream_plane_mode(plain, TCFG, cache(2, 32))
    mixed = dict(plain, layers=dict(plain["layers"], o_proj=tparams["layers"]["o_proj"]))
    assert not TT.stream_plane_mode(mixed, TCFG, cache(1, 32))
    k, v = TT.plane_views(cache(1, 32))
    assert k.shape == (3, 32, 32) and k.is_contiguous()
