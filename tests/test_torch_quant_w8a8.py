"""The port's w8a8 scope (``ops/quant.py``) against the JAX package's (CPU).

Mirrors ``tests/test_quant.py``'s w8a8 tests on the port: the product
tracks the dense matmul, the scope is off by default and restores, disable
is sticky under nesting, integer activations are exact, a ``[B, m, K]``
batch folds into rows. ``w8a8_matmul`` must equal the JAX package's
``_w8a8_matmul`` bit for bit in f32 on the same numpy inputs (the same
rounding, an exact int32 product, the two scales applied in the same
order). Then the pipeline: ``Qwen3TTS(quantize_int8=True,
int8_activations=True)`` gives the JAX package's frames through
``synthesize_batch`` at B = 3, token for token, with uneven EOS (the
``EOS_BOOST`` model of ``test_torch_batch.py``), and its audio within
atol 1e-5; its solo ``synthesize_with_timing`` is bit-equal to the same
model's without ``int8_activations``; ``int8_activations`` without
``quantize_int8`` raises. The card's padding (``w8a8_padded``: rows, K and
N zero-padded to what ``torch._int_mm`` takes there, the weight
column-major) leaves the int32 product bit-equal to the unpadded one at any
K and N.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_tts_tpu.pipeline as JP
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions
from test_torch_batch import EOS_TEXTS, TEMPERATURES, check_batch, eos_models
from test_torch_voice_clone import build_models

torch.set_num_threads(1)


def _quantized(rs, k: int, n: int) -> dict:
    return quant.quantize_linear(torch.from_numpy(rs.randn(k, n).astype(np.float32) * 0.05))


@pytest.mark.parametrize("m,k,n", [(1, 2050, 3074), (3, 7, 5), (17, 2048, 3072), (40, 13, 1), (24, 16, 8)])
def test_w8a8_padded_product_is_exact(m, k, n):
    g = torch.Generator().manual_seed(m * k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    xp, wp = quant.w8a8_padded(x, w)
    a = quant.W8A8_ALIGN
    assert xp.shape[0] > quant.W8A8_MIN_ROWS and xp.shape[0] % a == xp.shape[1] % a == wp.shape[1] % a == 0
    assert xp.shape[1] == wp.shape[0] and xp.shape[0] >= m and wp.shape[1] >= n
    assert wp.stride() == (1, wp.shape[0])  # column-major
    assert torch.equal(torch._int_mm(xp, wp)[:m, :n], torch._int_mm(x, w))


def test_w8a8_matmul_close_to_dense():
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(4, 256).astype(np.float32))
    w = torch.from_numpy(rs.randn(256, 512).astype(np.float32) * 0.05)
    q = quant.quantize_linear(w)
    with quant.w8a8_scope(True):
        out_q = quant.mm(x, q).numpy()
    out_d = (x @ w).numpy()
    for i in range(4):
        cos = out_q[i] @ out_d[i] / (np.linalg.norm(out_q[i]) * np.linalg.norm(out_d[i]))
        assert cos > 0.999, cos


def test_w8a8_scope_is_off_by_default_and_restores():
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 128).astype(np.float32))
    q = _quantized(rs, 128, 256)
    base = quant.mm(x, q)
    assert not quant._w8a8_allowed()
    with quant.w8a8_scope(True):
        assert quant._w8a8_allowed()
        inner = quant.mm(x, q)
    assert not quant._w8a8_allowed()
    torch.testing.assert_close(quant.mm(x, q), base, rtol=0, atol=0)
    assert (inner - base).abs().max() > 0  # activation rounding: another number


def test_w8a8_scope_disable_is_sticky_under_nesting():
    with quant.w8a8_scope(False):
        with quant.w8a8_scope(True):
            assert not quant._w8a8_allowed()
        assert not quant._w8a8_allowed()
    with quant.w8a8_scope(True):
        with quant.w8a8_scope(True):
            assert quant._w8a8_allowed()
    assert not quant._w8a8_allowed()


def test_w8a8_scope_is_thread_local():
    """A scope entered on one thread does not reach another (a server's
    worker enters its own)."""
    seen = []
    with quant.w8a8_scope(True):
        t = threading.Thread(target=lambda: seen.append(quant._w8a8_allowed()))
        t.start()
        t.join(30)
        assert not t.is_alive()
        assert quant._w8a8_allowed()
    assert seen == [False]


def test_w8a8_int_dot_is_exact_for_integer_activations():
    rs = np.random.RandomState(8)
    xi = rs.randint(-127, 128, (3, 128)).astype(np.float32)
    q = _quantized(rs, 128, 256)
    deq = q["q8"].numpy().astype(np.float32) * q["scale"].numpy()[None, :]
    for row in xi:  # per-row absmax 127 -> x_scale = 1 -> xq == xi exactly
        row[np.argmax(np.abs(row))] = 127.0
    with quant.w8a8_scope(True):
        out = quant.mm(torch.from_numpy(xi), q).numpy()
    np.testing.assert_allclose(out, xi @ deq, rtol=1e-6, atol=1e-4)
    want = np.asarray(jq._w8a8_matmul(jnp.asarray(xi), jnp.asarray(q["q8"].numpy()), jnp.asarray(q["scale"].numpy())))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("m,k,n,seed", [(1, 256, 384, 0), (3, 128, 256, 1), (8, 512, 640, 2), (24, 256, 128, 3),
                                        (80, 128, 512, 4)])
def test_w8a8_matmul_bit_equal_to_jax(m, k, n, seed):
    """The same f32 inputs through both packages give the same bits,
    near-ties of the rounding included (a column of x.5 multiples of the
    row scale)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, k) * rs.uniform(0.1, 3.0, (m, 1))).astype(np.float32)
    x[:, 1] = np.abs(x).max(axis=1) * (np.arange(m) % 7 + 0.5) / 127.0
    q = _quantized(rs, k, n)
    got = quant.w8a8_matmul(torch.from_numpy(x), q["q8"], q["scale"])
    want = np.asarray(jq._w8a8_matmul(jnp.asarray(x), jnp.asarray(q["q8"].numpy()), jnp.asarray(q["scale"].numpy())))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_w8a8_matmul_bf16_matches_jax():
    """bf16 activations: quantized from their f32 values, output cast back
    to bf16, as in the JAX package."""
    rs = np.random.RandomState(12)
    x = rs.randn(8, 256).astype(np.float32)
    q = _quantized(rs, 256, 384)
    got = quant.w8a8_matmul(torch.from_numpy(x).to(torch.bfloat16), q["q8"], q["scale"])
    want = jq._w8a8_matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q["q8"].numpy()),
                           jnp.asarray(q["scale"].numpy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_w8a8_batch_folds_into_rows():
    """``int8_matmul`` on [B, m, K] under the scope is B calls on [m, K]
    (each row quantized on its own): the batch folds into rows."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(5, 2, 256).astype(np.float32))
    q = _quantized(rs, 256, 512)
    with quant.w8a8_scope(True):
        batched = quant.mm(x, q)
        for i in range(5):
            torch.testing.assert_close(batched[i], quant.mm(x[i], q), rtol=0, atol=0)
    assert batched.shape == (5, 2, 512)


@pytest.fixture(scope="module")
def float_models():
    return eos_models(build_models())


@pytest.fixture(scope="module")
def w8a8_models(float_models):
    """``eos_models``' trees as int8 w8a8 models in both packages, and the
    port's weight-only twin."""
    jm, tm = float_models
    j8 = JP.Qwen3TTS(jm.config, jm.talker_params, jm.cp_params, jm.vocoder_params, jm.tokenizer,
                     vocoder_config=jm.vocoder_config, quantize_int8=True, int8_activations=True)
    kw = dict(vocoder_config=tm.vocoder_config, quantize_int8=True)
    t8 = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer, **kw,
                  int8_activations=True)
    weight_only = Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer, **kw)
    assert j8.w8a8 and t8.w8a8 and not weight_only.w8a8
    return j8, t8, weight_only


# Three of the uneven-EOS texts; with seed 2 under PCG the last stream
# meets EOS at frame 13 and the others run to 16.
W8A8_TEXTS = EOS_TEXTS[1:]


@TEMPERATURES
def test_w8a8_batch_matches_jax(w8a8_models, temperature):
    jm, tm, _ = w8a8_models
    frames, _ = check_batch(jm, tm, W8A8_TEXTS, max_length=16, seed=2, temperature=temperature)
    if temperature:
        assert len({len(f) for f in frames}) > 1, [len(f) for f in frames]


def test_w8a8_batch_differs_from_weight_only(w8a8_models):
    """The scope reaches the batched loop: its logits move, so the frames
    of a PCG batch are not the weight-only model's."""
    _, tm, weight_only = w8a8_models
    opts = SynthesisOptions(max_length=16, seed=2)
    a = tm.synthesize_batch(W8A8_TEXTS, options=opts)
    b = weight_only.synthesize_batch(W8A8_TEXTS, options=opts)
    assert any(x.samples.shape != y.samples.shape or np.abs(x.samples - y.samples).max() > 0 for x, y in zip(a, b))


def test_solo_paths_stay_weight_only(w8a8_models):
    _, tm, weight_only = w8a8_models
    opts = SynthesisOptions(max_length=12, seed=5)
    got, timing = tm.synthesize_with_timing("Solo request.", "ryan", "english", opts)
    want, _ = weight_only.synthesize_with_timing("Solo request.", "ryan", "english", opts)
    assert timing.generation_frames > 0
    np.testing.assert_array_equal(got.samples, want.samples)


def test_int8_activations_requires_quantize_int8(float_models):
    _, tm = float_models
    with pytest.raises(ValueError, match="int8_activations requires quantize_int8"):
        Qwen3TTS(tm.config, tm.talker_params, tm.cp_params, tm.vocoder_params, tm.tokenizer,
                 vocoder_config=tm.vocoder_config, int8_activations=True)
