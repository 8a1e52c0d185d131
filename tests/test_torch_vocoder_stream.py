"""The port's streaming vocoder against the JAX package's (f32, CPU).

* ``decode_stream_chunk`` fed in chunks of 1, 3 and 10 frames at
  ``TINY_VOC`` against the JAX package's ``decode_stream_chunk`` fed the
  same chunks (atol 1e-5), and against the port's own batch ``decode``
  (atol 2e-6, the JAX package's bar for the same pair in
  ``tests/test_vocoder.py``).
* A stream whose KV cache grows mid-stream (zero rows padded, as a
  session's growth pads it) against the batch decode and the JAX package's
  grown stream.
* ``fused_blocks.residual_unit_stream`` (on CPU tensors its plain version)
  in chunks against the JAX package's ``residual_unit_stream`` (the fused
  Pallas unit in interpret mode, as ``tests/test_fused_vocoder.py`` runs
  it), and against one batch call.
The CUDA stream entry is compared with its plain version and with one
batch launch on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models.codec import fused_blocks as jfb
from qwen3_tts_tpu.models.codec import vocoder as jvoc
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec import fused_blocks as tfb
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from test_pipeline import TINY_VOC
from test_torch_vocoder import _port_voc_cfg, _unit_params

torch.set_num_threads(1)

FRAMES = 21
CFG = _port_voc_cfg(TINY_VOC)


@pytest.fixture(scope="module")
def voc():
    jp = jax.jit(jvoc.init_vocoder_params, static_argnums=1)(jax.random.PRNGKey(12), TINY_VOC)
    tp = TW.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    codes = np.random.RandomState(8).randint(0, 2048, size=(1, 16, FRAMES)).astype(np.int32)
    with torch.no_grad():
        batch = tvoc.decode(tp, CFG, torch.from_numpy(codes)).numpy()
    return jp, tp, codes, batch


def _port_stream(tp, codes, chunks, grow_at=None, max_frames=32):
    state = tvoc.init_stream_state(CFG, max_frames, device="cpu")
    outs, i = [], 0
    for s in chunks:
        if i == grow_at:
            pad = torch.zeros_like(state.kv_k)
            state = state._replace(kv_k=torch.cat([state.kv_k, pad], 2), kv_v=torch.cat([state.kv_v, pad], 2))
        wav, state = tvoc.decode_stream_chunk(tp, CFG, state, torch.from_numpy(codes[:, :, i:i + s]))
        outs.append(wav.numpy())
        i += s
    assert state.pos == i
    return np.concatenate(outs, axis=1)


def _jax_stream(jp, codes, chunks, grow_at=None, max_frames=32):
    state = jvoc.init_stream_state(TINY_VOC, max_frames=max_frames)
    outs, i = [], 0
    for s in chunks:
        if i == grow_at:
            pad = ((0, 0), (0, 0), (0, max_frames), (0, 0), (0, 0))
            state = state._replace(kv_k=jnp.pad(state.kv_k, pad), kv_v=jnp.pad(state.kv_v, pad))
        wav, state = jvoc.decode_stream_chunk_jit(jp, TINY_VOC, state, jnp.asarray(codes[:, :, i:i + s]))
        outs.append(np.asarray(wav))
        i += s
    return np.concatenate(outs, axis=1)


def _chunks(chunk: int, total: int = FRAMES) -> list[int]:
    return [min(chunk, total - i) for i in range(0, total, chunk)]


@pytest.mark.parametrize("chunk", [1, 3, 10])
def test_stream_chunks_match_jax(voc, chunk):
    jp, tp, codes, _ = voc
    got = _port_stream(tp, codes, _chunks(chunk))
    want = _jax_stream(jp, codes, _chunks(chunk))
    assert got.shape == want.shape == (1, FRAMES * CFG.total_upsample)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("chunk", [1, 3, 10])
def test_stream_matches_batch_decode(voc, chunk):
    _, tp, codes, batch = voc
    got = _port_stream(tp, codes, _chunks(chunk))
    assert got.shape == batch.shape
    np.testing.assert_allclose(got, batch, rtol=0, atol=2e-6)


def test_stream_kv_grown_mid_stream(voc):
    """The KV cache padded with zero rows after 6 frames (16 -> 32 rows):
    rows past pos are masked, so the stream still equals the batch decode,
    and the JAX package's stream grown the same way."""
    jp, tp, codes, batch = voc
    chunks = _chunks(3)
    got = _port_stream(tp, codes, chunks, grow_at=6, max_frames=16)
    np.testing.assert_allclose(got, batch, rtol=0, atol=2e-6)
    want = _jax_stream(jp, codes, chunks, grow_at=6, max_frames=16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stream_state_layout_matches_jax():
    """The carried rows of every conv, and the KV cache, have the JAX
    package's shapes."""
    got = tvoc.init_stream_state(CFG, 8, batch=2, device="cpu")
    want = jvoc.init_stream_state(TINY_VOC, max_frames=8, batch=2)
    assert got.kv_k.shape == want.kv_k.shape and got.pos == 0
    shapes = jax.tree.map(lambda a: tuple(a.shape), want.conv)
    assert jax.tree.map(lambda a: tuple(a.shape), got.conv) == shapes


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_stream_matches_jax(dilation):
    rs = np.random.RandomState(20 + dilation)
    c = 48
    p = _unit_params(rs, c)
    x = rs.randn(2, 300, c).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jcarry = jnp.zeros((2, 6 * dilation, c), jnp.float32)
    tcarry = torch.zeros((2, 6 * dilation, c))
    jouts, touts = [], []
    before = tfb.residual_unit_stream.launches
    for lo, hi in [(0, 40), (40, 41), (41, 200), (200, 300)]:
        out, jcarry = jfb.residual_unit_stream(jnp.asarray(x[:, lo:hi]), jcarry, jp, dilation)
        jouts.append(np.asarray(out))
        out, tcarry = tfb.residual_unit_stream(torch.from_numpy(x[:, lo:hi]), tcarry, tp, dilation)
        touts.append(out.numpy())
    assert tfb.residual_unit_stream.launches == before  # CPU tensors take the plain version
    got = np.concatenate(touts, axis=1)
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=1), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcarry.numpy(), x[:, -6 * dilation:])
    batch = tfb.residual_unit_plain(torch.from_numpy(x), tp, dilation).numpy()
    np.testing.assert_allclose(got, batch, rtol=0, atol=1e-6)
