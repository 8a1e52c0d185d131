"""The port's sampling is token-exact against the JAX package's.

Same logits (numpy seed) and the same PCG uniforms go through
``qwen3_tts_tpu/ops/sampling.py`` and its port; every sampled token, the
penalised logits and the filters must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.ops import rng
from qwen3_tts_tpu.ops import sampling as js
from qwen3_tts_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)

VOCAB = 3072


def _logits(seed: int, n: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    # A peaked head over a flat tail, like a trained codec head; plus ties.
    x = (rs.randn(n, VOCAB) * 2.0).astype(np.float32)
    x[:, :8] += 6.0
    x[:, 100] = x[:, 101]
    return x


@pytest.mark.parametrize("temperature", [0.0, 0.7, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 5, 50])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
def test_sample_token_exact(temperature, top_k, top_p):
    jcfg = js.SamplingConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    tcfg = ts.SamplingConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    logits = _logits(int(temperature * 10) + top_k + int(top_p * 100), 8)
    uniforms = rng.pcg_uniform_sequence(42, len(logits))
    for row, u in zip(logits, uniforms):
        want = int(js.sample(jnp.asarray(row[None]), jcfg, jnp.float32(u))[0])
        got = int(ts.sample(torch.from_numpy(row[None]), tcfg, torch.tensor(u))[0])
        assert got == want


@pytest.mark.parametrize("token_count", [0, 1, 5])
def test_generation_penalties_equal(token_count):
    logits = _logits(7, 1)
    mask = (np.random.RandomState(8).rand(VOCAB) < 0.05).astype(np.float32)
    cfg_j, cfg_t = js.SamplingConfig(min_new_tokens=2), ts.SamplingConfig(min_new_tokens=2)
    supp_j, supp_t = js.build_suppression_mask(), ts.build_suppression_mask()
    np.testing.assert_array_equal(supp_t.numpy(), np.asarray(supp_j))
    want = js.apply_generation_penalties(jnp.asarray(logits), jnp.asarray(mask), supp_j, cfg_j, jnp.int32(token_count))
    got = ts.apply_generation_penalties(torch.from_numpy(logits), torch.from_numpy(mask), supp_t, cfg_t, token_count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filters_and_multinomial_equal():
    logits = _logits(9, 4)
    for k in (1, 7, 50):
        np.testing.assert_array_equal(
            ts.top_k_filter(torch.from_numpy(logits), k).numpy(), np.asarray(js.top_k_filter(jnp.asarray(logits), k))
        )
    for p in (0.3, 0.9):
        np.testing.assert_array_equal(
            ts.top_p_filter(torch.from_numpy(logits), p).numpy(), np.asarray(js.top_p_filter(jnp.asarray(logits), p))
        )
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    for u in (0.0, 0.3, 0.999999, 1.5):
        np.testing.assert_array_equal(
            ts.multinomial(torch.from_numpy(probs), torch.tensor(u)).numpy(),
            np.asarray(js.multinomial(jnp.asarray(probs), jnp.float32(u))),
        )
