"""The port's transformer ops against the JAX package's (f32, CPU).

Same inputs, made from a numpy seed, go through ``qwen3_tts_tpu/ops/nn.py``
and ``qwen3_tts_tpu_torch/ops/nn.py``; results agree to atol 1e-5 (f32
summation order differs between XLA and PyTorch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.ops import nn as jnn
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

ATOL = 1e-5
STACK = dict(hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def _layer_params(rs: np.random.RandomState, fused: bool) -> dict:
    s = STACK
    L, H, I, D = s["num_layers"], s["hidden_size"], s["intermediate_size"], s["head_dim"]
    q, kv = s["num_heads"] * D, s["num_kv_heads"] * D

    def w(*shape):
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    p = {
        "q_proj": w(L, H, q), "k_proj": w(L, H, kv), "v_proj": w(L, H, kv), "o_proj": w(L, q, H),
        "q_norm": 1 + w(L, D), "k_norm": 1 + w(L, D), "input_ln": 1 + w(L, H), "post_ln": 1 + w(L, H),
        "gate_proj": w(L, H, I), "up_proj": w(L, H, I), "down_proj": w(L, I, H),
    }
    if fused:
        return {"layers": JW.fuse_layer_params({k: jnp.asarray(v) for k, v in p.items()})}
    return {"layers": p}


def test_rms_norm():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 64).astype(np.float32) * 3
    w = rs.randn(64).astype(np.float32)
    _close(tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), jnn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rs = np.random.RandomState(1)
    _close(tnn.rope_inv_freq(16, theta), jnn.rope_inv_freq(16, theta))
    pos = np.array([0, 1, 7, 40, 300], np.float32)
    tcs = tnn.rope_cos_sin(torch.from_numpy(pos), tnn.rope_inv_freq(16, theta))
    jcs = jnn.rope_cos_sin(jnp.asarray(pos), jnn.rope_inv_freq(16, theta))
    _close(tcs[0], jcs[0])
    _close(tcs[1], jcs[1])
    x = rs.randn(1, 5, 4, 16).astype(np.float32)
    _close(tnn.apply_rope(torch.from_numpy(x), *tcs), jnn.apply_rope(jnp.asarray(x), *jcs))


@pytest.mark.parametrize("masked", [False, True])
def test_gqa_attention(masked):
    rs = np.random.RandomState(2)
    q = rs.randn(1, 3, 4, 16).astype(np.float32)
    k = rs.randn(1, 7, 2, 16).astype(np.float32)
    v = rs.randn(1, 7, 2, 16).astype(np.float32)
    mask = (np.arange(7)[None, :] <= np.array([2, 4, 6])[:, None])[None, None, None] if masked else None
    got = tnn.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            None if mask is None else torch.from_numpy(mask), 0.25)
    want = jnn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if mask is None else jnp.asarray(mask), 0.25)
    _close(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_layer_stack_prefill_then_decode(fused):
    """A 6-row fresh-cache prefill, then 3 decode steps, against JAX: hidden
    states and every cache row."""
    rs = np.random.RandomState(3 + fused)
    jparams = _layer_params(rs, fused)
    tparams = TW.from_numpy_tree({k: np.asarray(v) for k, v in jparams["layers"].items()}, "cpu")
    jcfg, tcfg = jnn.LayerStackConfig(**STACK), tnn.LayerStackConfig(**STACK)
    max_seq = 12
    jcache = jnn.init_kv_cache(jcfg, 1, max_seq, jnp.float32)
    tcache = tnn.init_kv_cache(tcfg, 1, max_seq, torch.float32)

    x = rs.randn(1, 6, 64).astype(np.float32)
    jh, jcache = jnn.run_layer_stack(jparams["layers"], jnp.asarray(x), jcfg, jcache,
                                     jnp.arange(6, dtype=jnp.int32), jnp.int32(0), self_attn_prefill=True)
    th = tnn.run_layer_stack(tparams, torch.from_numpy(x), tcfg, tcache, torch.arange(6), 0,
                             self_attn_prefill=True)
    _close(th, jh)
    for pos in range(6, 9):
        x = rs.randn(1, 1, 64).astype(np.float32)
        jh, jcache = jnn.run_layer_stack(jparams["layers"], jnp.asarray(x), jcfg, jcache,
                                         jnp.array([pos], jnp.int32), jnp.int32(pos))
        th = tnn.run_layer_stack(tparams, torch.from_numpy(x), tcfg, tcache, torch.tensor([pos]), pos)
        _close(th, jh)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)
