"""The port's vocoder against the JAX package's (f32, CPU).

* The plain residual unit (what ``fused_blocks.residual_unit`` runs on a CPU
  tensor) against the JAX fused Pallas unit in interpret mode, as
  ``tests/test_fused_vocoder.py`` runs it: dilations 1/3/9, T not a multiple
  of its 256-row tile, atol 1e-5.
* The whole ``decode`` against JAX ``vocoder.decode`` at ``TINY_VOC``.
* ``decode_bucketed`` does not depend on the bucket.
The CUDA kernel is compared with the plain version on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models.codec import blocks as jblocks
from qwen3_tts_tpu.models.codec import fused_blocks as jfb
from qwen3_tts_tpu.models.codec import vocoder as jvoc
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.codec import blocks as tblocks
from qwen3_tts_tpu_torch.models.codec import fused_blocks as tfb
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc
from test_pipeline import TINY_VOC

torch.set_num_threads(1)


def _unit_params(rs, c):
    return {
        "act1_alpha": rs.randn(c).astype(np.float32) * 0.1,
        "act1_beta": rs.randn(c).astype(np.float32) * 0.1,
        "conv1_w": rs.randn(7, c, c).astype(np.float32) * 0.05,
        "conv1_b": rs.randn(c).astype(np.float32) * 0.1,
        "act2_alpha": rs.randn(c).astype(np.float32) * 0.1,
        "act2_beta": rs.randn(c).astype(np.float32) * 0.1,
        "conv2_w": rs.randn(1, c, c).astype(np.float32) * 0.05,
        "conv2_b": rs.randn(c).astype(np.float32) * 0.1,
    }


def _port_voc_cfg(cfg) -> tvoc.VocoderConfig:
    return tvoc.VocoderConfig(**{f: getattr(cfg, f) for f in tvoc.VocoderConfig.__dataclass_fields__})


@pytest.mark.parametrize("c", [48, 96])
@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_matches_jax_kernel(c, dilation):
    rs = np.random.RandomState(c + dilation)
    p = _unit_params(rs, c)
    x = rs.randn(2, 300, c).astype(np.float32)
    want = jfb.residual_unit(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, dilation)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    before = tfb.residual_unit.launches
    got = tblocks.residual_unit(torch.from_numpy(x), tp, dilation)  # routes to the wrapper
    assert tfb.residual_unit.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_conv_blocks_match_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(1, 37, 24).astype(np.float32)
    w = rs.randn(7, 24, 16).astype(np.float32) * 0.1
    b = rs.randn(16).astype(np.float32)
    for dil in (1, 3):
        np.testing.assert_allclose(
            tblocks.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dil).numpy(),
            np.asarray(jblocks.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil)),
            rtol=0, atol=1e-5,
        )
    tw = rs.randn(10, 16, 24).astype(np.float32) * 0.1  # [K, Cout, Cin], stride 5
    np.testing.assert_allclose(
        tblocks.causal_trans_conv1d(torch.from_numpy(x), torch.from_numpy(tw), torch.from_numpy(b), 5).numpy(),
        np.asarray(jblocks.causal_trans_conv1d(jnp.asarray(x), jnp.asarray(tw), jnp.asarray(b), 5)),
        rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("groups", [2, 4, 8])
def test_grouped_causal_conv_matches_jax(groups, dilation, bias):
    """``causal_conv1d`` with 1 < groups < Cin (Cin 24, Cout 16) against the
    JAX function's ``conv_general_dilated`` with ``feature_group_count``."""
    rs = np.random.RandomState(groups * 10 + dilation)
    x = rs.randn(2, 37, 24).astype(np.float32)
    w = rs.randn(5, 24 // groups, 16).astype(np.float32) * 0.1
    b = rs.randn(16).astype(np.float32) if bias else None
    got = tblocks.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                                dilation, groups)
    want = jblocks.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), dilation,
                                 groups)
    assert got.shape == (2, 37, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("groups,kernel_shape", [(5, (3, 4, 16)), (3, (3, 8, 16)), (4, (3, 8, 16))],
                         ids=["cin", "cout", "kernel"])
def test_grouped_causal_conv_refuses_channels_groups_do_not_divide(groups, kernel_shape):
    """Cin 24 not a multiple of 5, Cout 16 not of 3, or a kernel whose
    Cin/groups is not x's: ``ValueError``, as XLA refuses them."""
    x = torch.zeros((1, 8, 24))
    with pytest.raises(ValueError, match="groups"):
        tblocks.causal_conv1d(x, torch.zeros(kernel_shape), None, 1, groups)


@pytest.fixture(scope="module")
def voc_params():
    jp = jax.jit(jvoc.init_vocoder_params, static_argnums=1)(jax.random.PRNGKey(11), TINY_VOC)
    return jp, TW.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def test_decode_matches_jax(voc_params):
    jp, tp = voc_params
    codes = np.random.RandomState(6).randint(0, 2048, size=(1, 16, 10)).astype(np.int32)
    want = np.asarray(jvoc.decode_jit(jp, TINY_VOC, jnp.asarray(codes)))
    with torch.no_grad():
        got = tvoc.decode(tp, _port_voc_cfg(TINY_VOC), torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (1, 10 * TINY_VOC.total_upsample)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The tiny random vocoder's audio is small; hold it to f32 precision too.
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_decode_bucketed_is_bucket_invariant(voc_params):
    _, tp = voc_params
    cfg = _port_voc_cfg(TINY_VOC)
    codes = np.random.RandomState(7).randint(0, 64, size=(1, 16, 21)).astype(np.int32)
    w16 = tvoc.decode_bucketed(tp, cfg, codes, bucket=16)
    w32 = tvoc.decode_bucketed(tp, cfg, codes, bucket=32)
    with torch.no_grad():
        direct = tvoc.decode(tp, cfg, torch.from_numpy(codes)).numpy()
    assert w16.shape == w32.shape == direct.shape == (1, 21 * cfg.total_upsample)
    np.testing.assert_allclose(w16, direct, rtol=0, atol=1e-6)
    np.testing.assert_allclose(w16, w32, rtol=0, atol=1e-6)
