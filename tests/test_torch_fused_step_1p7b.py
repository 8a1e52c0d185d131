"""Kernels 5 and 6's reference at full width: one int8 decode step of the
1.7B code predictor's 5 layers at intermediate 2816 through the per-layer
route, the JAX package and the port, on the CPU in f32.

Seeded numpy weights at the 1.7B code predictor's widths with intermediate
2816 (``qwen3_tts_tpu_torch.cp_fixture.fused_step_config``: not a multiple
of the hidden 1024, so the JAX gates hold no stream pack and send the code
predictor to kernels 5 + 6), fused and quantized to int8, and the seeded
inputs of kernel 7's fixture at the positions 2 and 16 of a 17-row cache go
to both packages. The JAX package's ``run_fused_decode_step`` without a
pack (``fused_attention_step`` and ``fused_mlp_step`` per layer, its Pallas
kernels in interpret mode) must give the committed fixture within 1e-5 of
its largest value (the same program on the same CPU). The port's plain
route (``fused_layer.run_fused_decode_step(..., streamed=False)``: what the
kernels' wrappers run on CPU tensors) must give the JAX outputs, and the
fixture, within 4e-3 of their largest value (kernel 7's fixture bar: the
int8 matmuls round their inputs to bf16 in f32 programs too, so an f32 sum
in another order can move an input by a bf16 ulp near a rounding boundary,
and that carries through the 5 layers), and the JAX package's written cache
rows likewise, every other row unchanged; a step whose residual stream is
rounded to bf16 must fail the bar. ``chip_smoke.py`` holds the f32 kernels,
through a ``FusedStepPack``, to the same fixture on the card.

    JAX_PLATFORMS=cpu python tests/test_torch_fused_step_1p7b.py   # rewrites the fixture
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu.ops import fused_layer as jfl  # noqa: E402
from qwen3_tts_tpu.ops import nn as jnn  # noqa: E402
from qwen3_tts_tpu_torch import cp_fixture  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer as tfl  # noqa: E402
from qwen3_tts_tpu_torch.ops import nn as tnn  # noqa: E402

TOL = 4e-3
FIXTURE_TOL = 1e-5


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def jax_steps(layers: dict, stack) -> list:
    """The JAX package's per-layer route without a stream pack: for each
    position, (y [H], the caches k, v after the step)."""
    jl = jax.tree.map(jnp.asarray, _numpy(layers))
    assert jfl.make_stream_pack(jl, stack) is None  # the JAX gates: kernels 5 + 6
    inv = jnn.rope_inv_freq(stack.head_dim, stack.rope_theta)
    cos_t, sin_t = jnn.rope_cos_sin(jnp.arange(cp_fixture.STEP_ROWS, dtype=jnp.float32), inv)
    out = []
    for pos, x, k, v in cp_fixture.step_inputs(cp_fixture.fused_step_config()):
        y, ck, cv = jfl.run_fused_decode_step(jl, jnp.asarray(x), stack, jnp.asarray(k), jnp.asarray(v),
                                              jnp.int32(pos), cos_t, sin_t)
        out.append((np.asarray(y).reshape(-1), np.asarray(ck), np.asarray(cv)))
    return out


@pytest.fixture(scope="module")
def steps():
    torch.set_num_threads(4)
    cfg = cp_fixture.fused_step_config()
    stack = cfg.layer_stack()
    layers = cp_fixture.step_layers(cfg)
    return stack, layers, jax_steps(layers, stack)


def test_jax_package_gives_the_fixture(steps):
    _, _, jsteps = steps
    want = cp_fixture.load_fused_step()
    assert want.shape == (len(cp_fixture.STEP_POSITIONS), cp_fixture.fused_step_config().hidden_size)
    for (y, _, _), row in zip(jsteps, want):
        np.testing.assert_allclose(y, row, rtol=0, atol=FIXTURE_TOL * np.abs(row).max())


def test_port_plain_route_gives_the_fixture(steps):
    stack, layers, jsteps = steps
    cos_t, sin_t = tfl.rope_tables(stack.head_dim, stack.rope_theta, cp_fixture.STEP_ROWS, torch.device("cpu"))
    fixture = cp_fixture.load_fused_step()
    counters = (tfl.fused_attention_step, tfl.fused_mlp_step)
    before = [k.launches for k in counters]
    cfg = cp_fixture.fused_step_config()
    for (pos, x, k0, v0), (jy, jk, jv), row in zip(cp_fixture.step_inputs(cfg), jsteps, fixture):
        ck, cv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        y = tfl.run_fused_decode_step(layers, torch.from_numpy(x), stack, ck, cv, pos, cos_t, sin_t, False)
        assert y.dtype == torch.float32 and y.shape == (1, 1, stack.hidden_size)
        y = y.numpy().reshape(-1)
        for want in (jy, row):
            np.testing.assert_allclose(y, want, rtol=0, atol=TOL * np.abs(want).max())
        for got, want in ((ck.numpy(), jk), (cv.numpy(), jv)):
            np.testing.assert_allclose(got[:, pos], want[:, pos], rtol=0, atol=TOL * np.abs(want[:, pos]).max())
        others = np.arange(cp_fixture.STEP_ROWS) != pos
        assert np.array_equal(ck.numpy()[:, others], k0[:, others])
        assert np.array_equal(cv.numpy()[:, others], v0[:, others])
    assert [k.launches for k in counters] == before  # CPU tensors take the plain versions


def test_the_bar_rejects_a_bf16_residual_stream(steps):
    """The faulty route (the residual stream rounded to bf16 after every
    sub-layer) lies beyond TOL from the JAX package at every position."""
    stack, layers, jsteps = steps
    cos_t, sin_t = tfl.rope_tables(stack.head_dim, stack.rope_theta, cp_fixture.STEP_ROWS, torch.device("cpu"))
    bf16 = torch.bfloat16
    for (pos, x, k0, v0), (jy, _, _) in zip(cp_fixture.step_inputs(cp_fixture.fused_step_config()), jsteps):
        ck, cv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        h = torch.from_numpy(x).reshape(1, stack.hidden_size)
        for l in range(stack.num_layers):
            layer = tnn.layer_params_at(layers, l)
            h = tfl.fused_attention_step_plain(h, layer, cos_t, sin_t, ck[l], cv[l], pos, stack.num_heads,
                                               stack.num_kv_heads, stack.head_dim, stack.rms_norm_eps)
            h = tfl.fused_mlp_step_plain(h.to(bf16).float(), layer, stack.intermediate_size, stack.rms_norm_eps)
            h = h.to(bf16).float()
        assert np.abs(h.numpy().reshape(-1) - jy).max() > TOL * np.abs(jy).max(), pos


if __name__ == "__main__":
    cfg = cp_fixture.fused_step_config()
    ys = np.stack([y for y, _, _ in jax_steps(cp_fixture.step_layers(cfg), cfg.layer_stack())])
    np.save(cp_fixture.FUSED_STEP_FIXTURE, ys.astype(np.float32))
    print(f"wrote {cp_fixture.FUSED_STEP_FIXTURE}: {ys.shape}, max|y| {np.abs(ys).max():.4f}")
