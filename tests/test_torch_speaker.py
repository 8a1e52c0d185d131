"""The port's ECAPA-TDNN speaker encoder against the JAX package's (f32, CPU).

Seeded numpy weights at small widths (``encoder_fixture.
speaker_numpy_params``) go to both packages, the port's through
``models.weights.speaker_encoder_from_numpy``. The parts (the reflect-same
conv at the true length, TDNN, Res2Net, SE, attentive statistics pooling),
``forward`` and ``SpeakerEncoder.encode`` must agree within 1e-5 of the JAX
output's max|x|. The JAX package pads the mel to a frame bucket and masks
(or, at a bucket's exact length, runs unmasked); the port runs at the true
length, so both of its forms are checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import speaker as jspeaker
from qwen3_tts_tpu.models.config import SpeakerEncoderConfig as JConfig
from qwen3_tts_tpu_torch.encoder_fixture import speaker_numpy_params
from qwen3_tts_tpu_torch.models import speaker as tspeaker
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.models.config import SpeakerEncoderConfig

torch.set_num_threads(1)

SMALL = dict(enc_dim=48, enc_channels=(32, 32, 32, 32, 96), enc_attention_channels=16, enc_se_channels=16,
             enc_res2net_scale=4)
REL = 1e-5  # of the JAX output's max|x|


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * np.abs(want).max())


@pytest.fixture(scope="module")
def encoders():
    tree = speaker_numpy_params(SpeakerEncoderConfig(**SMALL), seed=5)
    jenc = jspeaker.SpeakerEncoder(jax.tree.map(jnp.asarray, tree), JConfig(**SMALL))
    tenc = tspeaker.SpeakerEncoder(TW.speaker_encoder_from_numpy(tree, "cpu"), SpeakerEncoderConfig(**SMALL))
    return jenc, tenc


def _cl(x: np.ndarray) -> torch.Tensor:
    """JAX channels-last [B, T, C] -> the port's [B, C, T]."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("cin,cout,k,dil,t", [(4, 8, 5, 1, 20), (8, 4, 3, 3, 11), (6, 6, 3, 4, 9), (5, 7, 1, 1, 6),
                                              (3, 5, 3, 4, 3)])
def test_reflect_same_conv_matches_jax(cin, cout, k, dil, t):
    """At the true length, against the JAX conv on a right-padded buffer
    reflected at ``true_len`` (and unpadded where the pad fits in T); the
    last case is shorter than its pad, where the gather clips."""
    rs = np.random.RandomState(k * 10 + dil)
    x = rs.randn(1, t, cin).astype(np.float32)
    w = rs.randn(k, cin, cout).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    got = tspeaker._reflect_same_conv(_cl(x), torch.from_numpy(w.transpose(2, 1, 0).copy()), torch.from_numpy(b), dil)
    padded = np.concatenate([x, rs.randn(1, 7, cin).astype(np.float32)], axis=1)
    want = jspeaker._reflect_same_conv(jnp.asarray(padded), jnp.asarray(w), jnp.asarray(b), dil, jnp.int32(t))
    _close(got.transpose(1, 2), np.asarray(want)[:, :t])
    if dil * (k - 1) // 2 < t:
        _close(got.transpose(1, 2), jspeaker._reflect_same_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil))


def test_parts_match_jax(encoders):
    jenc, tenc = encoders
    jp, tp, cfg = jenc.params, tenc.params, tenc.cfg
    rs = np.random.RandomState(1)
    x = rs.randn(1, 23, 32).astype(np.float32)
    block_j, block_t = jp["se_res2net"][1], tp["se_res2net"][1]
    _close(tspeaker._tdnn(_cl(x), tp["se_res2net"][0]["tdnn1"]).transpose(1, 2),
           jspeaker._tdnn(jnp.asarray(x), jp["se_res2net"][0]["tdnn1"]))
    _close(tspeaker._res2net(_cl(x), block_t["res2net"], cfg.enc_res2net_scale, 3).transpose(1, 2),
           jspeaker._res2net(jnp.asarray(x), block_j["res2net"], cfg.enc_res2net_scale, 3))
    _close(tspeaker._se_block(_cl(x), block_t["se"]).transpose(1, 2), jspeaker._se_block(jnp.asarray(x), block_j["se"]))
    _close(tspeaker._se_res2net(_cl(x), block_t, 3, cfg.enc_res2net_scale).transpose(1, 2),
           jspeaker._se_res2net(jnp.asarray(x), block_j, 3, cfg.enc_res2net_scale))
    h = rs.randn(1, 23, 96).astype(np.float32)
    _close(tspeaker._asp(_cl(h), tp["asp"]), jspeaker._asp(jnp.asarray(h), jp["asp"]))


@pytest.mark.parametrize("frames", [20, 47, 96])
def test_forward_matches_jax_masked_and_unmasked(encoders, frames):
    """The port at the true length against the JAX forward on the mel
    padded to its bucket and masked (both unmasked at a bucket's length)."""
    jenc, tenc = encoders
    mel = np.random.RandomState(frames).randn(1, 128, frames).astype(np.float32)
    got = tspeaker.forward(tenc.params, tenc.cfg, torch.from_numpy(mel))
    bucket = next(b for b in jspeaker.SpeakerEncoder.FRAME_BUCKETS if b >= frames)
    padded = np.zeros((1, 128, bucket), np.float32)
    padded[..., :frames] = mel
    # The JAX encoder's own jitted forward (``encode`` runs the same program).
    _close(got, jenc._fwd(jenc.params, mel=jnp.asarray(padded), true_len=jnp.int32(frames)))
    _close(got, jenc._fwd(jenc.params, mel=jnp.asarray(mel)))


@pytest.mark.parametrize("n", [12000, 24576, 30001])
def test_encode_matches_jax(encoders, n):
    """``encode`` on samples: 47 mel frames (bucket 48, masked), 96 (a
    bucket's exact length, unmasked) and 115 (bucket 192)."""
    jenc, tenc = encoders
    samples = (0.3 * np.random.RandomState(n).randn(n)).astype(np.float32)
    got = tenc.encode(samples)
    want = jenc.encode(samples)
    assert got.dtype == np.float32 and got.shape == (SMALL["enc_dim"],)
    _close(torch.from_numpy(got), want)


def test_converter_layout(encoders):
    """Every TDNN kernel in ``F.conv1d``'s [Cout, Cin, K], f32; the dense
    layers as the JAX package keeps them."""
    jenc, tenc = encoders
    jw, tw = np.asarray(jenc.params["initial"]["w"]), tenc.params["initial"]["w"]
    assert tw.dtype == torch.float32 and tuple(tw.shape) == jw.shape[::-1]
    np.testing.assert_array_equal(tw.numpy(), jw.transpose(2, 1, 0))
    assert len(tenc.params["se_res2net"][0]["res2net"]) == SMALL["enc_res2net_scale"] - 1
    np.testing.assert_array_equal(tenc.params["fc_w"].numpy(), np.asarray(jenc.params["fc_w"]))
