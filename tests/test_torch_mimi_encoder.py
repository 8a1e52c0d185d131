"""The port's Mimi encoder and vector quantizers against the JAX package's
(f32, CPU).

Seeded numpy weights at small widths (``encoder_fixture.
mimi_numpy_params``) go to both packages, the port's through
``models.weights.mimi_encoder_from_numpy``. The causal convs (strides,
dilations, replicate padding), ``stage_lengths``, the quantizers' input
(SEANet, transformer, downsample) and ``Encoder12Hz.encode`` must agree:
activations within 1e-5 of max|x|, codes equal code for code. The JAX
package buckets the samples and masks; the port runs at the true length.
``VectorQuantizer`` and ``ResidualVectorQuantizer``: the same codes and
embeddings as the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models.codec import encoder as jencoder
from qwen3_tts_tpu.models.codec import quantizer as jquantizer
from qwen3_tts_tpu_torch.encoder_fixture import mimi_numpy_params
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec import encoder as tencoder
from qwen3_tts_tpu_torch.models.codec import quantizer as tquantizer

torch.set_num_threads(1)

SMALL = dict(num_filters=8, hidden_size=32, num_layers=2, num_heads=2, head_dim=16, intermediate_size=64,
             codebook_size=128, codebook_dim=16, sliding_window=5)
REL = 1e-5  # of the JAX output's max|x|


@pytest.fixture(scope="module")
def encoders():
    jcfg, tcfg = jencoder.MimiEncoderConfig(**SMALL), tencoder.MimiEncoderConfig(**SMALL)
    tree = mimi_numpy_params(tcfg, seed=7)
    return (jencoder.Encoder12Hz(jax.tree.map(jnp.asarray, tree), jcfg),
            tencoder.Encoder12Hz(TW.mimi_encoder_from_numpy(tree, "cpu"), tcfg))


def test_config_matches_jax():
    jc, tc = jencoder.MimiEncoderConfig(), tencoder.MimiEncoderConfig()
    assert {f: getattr(tc, f) for f in tc.__dataclass_fields__} == {f: getattr(jc, f) for f in jc.__dataclass_fields__}


@pytest.mark.parametrize("n", [1, 7, 1919, 1920, 12000, 30001])
def test_stage_lengths_match_jax(n):
    cfg = tencoder.MimiEncoderConfig()
    assert tencoder.stage_lengths(cfg, n) == jencoder.stage_lengths(jencoder.MimiEncoderConfig(), n)
    for k_eff, stride in ((7, 1), (8, 4), (12, 6), (4, 2)):
        assert tencoder._causal_pad_amounts(n, k_eff, stride) == jencoder._causal_pad_amounts(n, k_eff, stride)


@pytest.mark.parametrize("k,stride,dilation,mode", [(7, 1, 1, "constant"), (8, 4, 1, "constant"), (3, 1, 3, "constant"),
                                                    (4, 2, 1, "replicate"), (10, 5, 1, "constant")])
def test_mimi_conv_matches_jax(k, stride, dilation, mode):
    rs = np.random.RandomState(k + stride)
    x = rs.randn(2, 23, 5).astype(np.float32)
    w = rs.randn(k, 5, 6).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    want = np.asarray(jencoder._mimi_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, dilation, mode))
    got = tencoder._mimi_conv(torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                              torch.from_numpy(b), stride, dilation, mode).transpose(1, 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_hidden_matches_jax(encoders):
    """The quantizers' input: SEANet, the sliding-window transformer (a
    window of 5 over 13 rows, so it is cut) and the downsample."""
    jenc, tenc = encoders
    audio = (0.3 * np.random.RandomState(0).randn(1, 12000)).astype(np.float32)
    p, cfg = jenc.params, jenc.cfg
    h = jencoder._seanet_encoder(p["seanet"], cfg, jnp.asarray(audio)[..., None])
    h = jencoder._transformer(p["transformer"], cfg, h)
    want = np.asarray(jencoder._mimi_conv(h, p["downsample_w"], None, stride=2, pad_mode="replicate"))
    got = tencoder.hidden(tenc.params, tenc.cfg, torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, 7, SMALL["hidden_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


@pytest.mark.parametrize("n", [0, 5000, 12000, 30001])
def test_encode_matches_jax(encoders, n):
    """Codes equal the JAX package's bucketed ``encode`` (12000 samples: a
    bucket's exact length; the others padded and masked); none within
    1e-3 of a tie."""
    jenc, tenc = encoders
    samples = (0.3 * np.random.RandomState(n).randn(n)).astype(np.float32)
    got, want = tenc.encode(samples), jenc.encode(samples)
    assert got.dtype == np.int32 and got.shape == want.shape == (tencoder.stage_lengths(tenc.cfg, n)[2] if n else 0, 16)
    np.testing.assert_array_equal(got, want)
    if n:
        h = tencoder.hidden(tenc.params, tenc.cfg, torch.from_numpy(samples)[None])
        margins = torch.cat([tencoder.rvq_margins(h, tenc.params[f"{k}_proj"], tenc.params[f"{k}_codebooks"])
                             for k in ("semantic", "acoustic")])
        assert margins.min().item() > 1e-3


def test_converter_layout(encoders):
    """SEANet and downsample kernels in ``F.conv1d``'s [Cout, Cin, K], f32;
    the stages' ``ratio`` gone (the config gives the strides)."""
    jenc, tenc = encoders
    stage_j, stage_t = jenc.params["seanet"]["stages"][1], tenc.params["seanet"]["stages"][1]
    np.testing.assert_array_equal(stage_t["down_w"].numpy(), np.asarray(stage_j["down_w"]).transpose(2, 1, 0))
    assert set(stage_t) == {"resnet", "down_w", "down_b"}
    assert tenc.params["downsample_w"].shape == (32, 32, 4) and tenc.params["downsample_w"].dtype == torch.float32


@pytest.mark.parametrize("batch,seq", [(1, 5), (3, 7)])
def test_vector_quantizer_matches_jax(batch, seq):
    rs = np.random.RandomState(batch * 10 + seq)
    codebook = rs.randn(64, 8).astype(np.float32)
    x = rs.randn(batch, seq, 8).astype(np.float32)
    jq, jidx = jquantizer.VectorQuantizer(jnp.asarray(codebook)).encode(jnp.asarray(x))
    tvq = tquantizer.VectorQuantizer(torch.from_numpy(codebook))
    tq, tidx = tvq.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tvq.size, tvq.dim) == (64, 8)
    # Codewords themselves come back as their own indices.
    np.testing.assert_array_equal(tvq.encode(torch.from_numpy(codebook[None, [3, 9, 3]]))[1].numpy(), [[3, 9, 3]])


def test_residual_quantizer_matches_jax():
    rs = np.random.RandomState(3)
    codebooks = rs.randn(4, 32, 8).astype(np.float32)
    x = rs.randn(2, 6, 8).astype(np.float32)
    jr = jquantizer.ResidualVectorQuantizer(jnp.asarray(codebooks))
    tr = tquantizer.ResidualVectorQuantizer(torch.from_numpy(codebooks))
    jsum, jidx = jr.encode(jnp.asarray(x))
    tsum, tidx = tr.encode(torch.from_numpy(x))
    assert tidx.shape == (2, 4, 6) and (tr.num_quantizers, tr.dim) == (4, 8)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.decode(tidx).numpy(), np.asarray(jr.decode(jidx)))
    np.testing.assert_allclose(tr.decode_sum(tidx).numpy(), np.asarray(jr.decode_sum(jidx)), rtol=0, atol=1e-6)
    # Residual quantization gets closer with every stage.
    err = [np.linalg.norm(x - tr.decode(tidx)[:, :, :q].sum(2).numpy()) for q in range(5)]
    assert all(a >= b for a, b in zip(err, err[1:]))
