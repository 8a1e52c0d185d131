"""The port's code-predictor frame against the JAX package's (f32, CPU).

At the ``STREAM_CFG`` size of ``tests/test_fused_layer.py``, with and
without the mtp projection, the port's plain frame (what ``cp_frame`` runs
on a CPU tensor) must give codes identical to both the JAX whole-frame Pallas
kernel ``streamed_cp_frame`` (interpret mode, run as that file runs it) and
``predict_acoustic_codes``. The CUDA kernel itself is compared with the plain
version on the card by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.ops import fused_layer as jfl
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig as TCodePredictorConfig
from qwen3_tts_tpu_torch.ops import fused_layer as tfl
from test_fused_layer import STREAM_CFG

torch.set_num_threads(1)


def _port_cfg(jcfg) -> TCodePredictorConfig:
    return TCodePredictorConfig(**{f: getattr(jcfg, f) for f in TCodePredictorConfig.__dataclass_fields__})


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("embed_dim", [None, 128])
def test_plain_frame_matches_jax_kernel_and_reference(embed_dim):
    cfg = dc_replace(STREAM_CFG, codec_embed_dim=embed_dim)
    base = JW.init_code_predictor_params(jax.random.PRNGKey(12), cfg, jnp.float32)
    params_frame = JW.fuse_model_params(base)
    params_frame["stream_pack"] = jfl.make_stream_pack(params_frame["layers"], cfg.layer_stack())
    assert jfl.supports_cp_frame_kernel(params_frame, cfg)

    rs = np.random.RandomState(7)
    e = cfg.embed_dim
    hidden = rs.randn(1, 1, e).astype(np.float32)
    semantic = rs.randn(1, 1, e).astype(np.float32)
    want_kernel = np.asarray(jfl.streamed_cp_frame(params_frame, cfg, jnp.asarray(hidden), jnp.asarray(semantic)))
    want_ref = np.asarray(jcp.predict_acoustic_codes(base, cfg, jnp.asarray(hidden), jnp.asarray(semantic)))
    np.testing.assert_array_equal(want_kernel, want_ref)

    tparams = TW.fuse_model_params(TW.from_numpy_tree(_numpy(base), "cpu"))
    assert (tparams["mtp_proj"] is None) == (embed_dim is None)
    before = tfl.cp_frame.launches
    got = tcp.predict_acoustic_codes(tparams, _port_cfg(cfg), torch.from_numpy(hidden), torch.from_numpy(semantic))
    assert tfl.cp_frame.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    # The unfused tree computes the same frame.
    unfused = TW.from_numpy_tree(_numpy(base), "cpu")
    np.testing.assert_array_equal(
        tfl.cp_frame_plain(unfused, _port_cfg(cfg), torch.from_numpy(hidden), torch.from_numpy(semantic)).numpy(),
        want_ref,
    )


def test_acoustic_embedding_sum_matches_jax():
    cfg = dc_replace(STREAM_CFG, codec_embed_dim=128)
    base = JW.init_code_predictor_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    codes = np.random.RandomState(4).randint(0, cfg.vocab_size, size=cfg.num_acoustic).astype(np.int32)
    want = np.asarray(jcp.acoustic_embedding_sum(base, jnp.asarray(codes)))
    got = tcp.acoustic_embedding_sum(TW.from_numpy_tree(_numpy(base), "cpu"), torch.from_numpy(codes))
    assert got.shape == want.shape == (1, 1, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_fuse_layer_params_matches_jax():
    base = JW.init_code_predictor_params(jax.random.PRNGKey(5), STREAM_CFG, jnp.float32)
    want = _numpy(JW.fuse_model_params(base))["layers"]
    got = TW.fuse_model_params(TW.from_numpy_tree(_numpy(base), "cpu"))["layers"]
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])


@pytest.mark.parametrize("embed_dim", [None, 128])
def test_int8_plain_frame_matches_jax_kernel_and_reference(embed_dim):
    """Weight-only int8 (the JAX package's quantize_code_predictor_params):
    the port's plain frame gives the codes of the interpret-mode
    ``streamed_cp_frame`` on int8 tiles and of the pack-free int8
    ``predict_acoustic_codes``, exactly (greedy codes; f32 activations)."""
    from qwen3_tts_tpu.ops import quant as jq

    cfg = dc_replace(STREAM_CFG, codec_embed_dim=embed_dim)
    base = jq.quantize_code_predictor_params(
        JW.fuse_model_params(JW.init_code_predictor_params(jax.random.PRNGKey(13), cfg, jnp.float32))
    )
    params_frame = dict(base)
    params_frame["stream_pack"] = jfl.make_stream_pack(base["layers"], cfg.layer_stack())
    assert params_frame["stream_pack"]["tiles"].dtype == jnp.int8
    assert jfl.supports_cp_frame_kernel(params_frame, cfg)

    rs = np.random.RandomState(8)
    e = cfg.embed_dim
    hidden = rs.randn(1, 1, e).astype(np.float32)
    semantic = rs.randn(1, 1, e).astype(np.float32)
    want_kernel = np.asarray(jfl.streamed_cp_frame(params_frame, cfg, jnp.asarray(hidden), jnp.asarray(semantic)))
    want_ref = np.asarray(jcp.predict_acoustic_codes(base, cfg, jnp.asarray(hidden), jnp.asarray(semantic)))
    np.testing.assert_array_equal(want_kernel, want_ref)

    tparams = TW.from_numpy_tree(_numpy(base), "cpu")
    assert tparams["lm_heads"]["q8"].dtype == torch.int8
    before = tfl.cp_frame.launches
    got = tcp.predict_acoustic_codes(tparams, _port_cfg(cfg), torch.from_numpy(hidden), torch.from_numpy(semantic))
    assert tfl.cp_frame.launches == before
    np.testing.assert_array_equal(got.numpy(), want_kernel)
