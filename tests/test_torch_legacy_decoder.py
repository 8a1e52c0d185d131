"""The legacy 25 Hz ``CodecDecoder`` of the port against the JAX package's (f32, CPU).

``CodecDecoder.from_weights`` on the JAX tests' synthetic HF weights
(``tests/test_quantizer._legacy_synthetic_weights``) decodes within 1e-5
of max|audio| of the JAX decoder on the same weights and tokens, at two
configurations (one with odd k - stride stages, whose transposed convs add
a sample, and one of two layers and four stages); ``output_length`` and the
audio's shape equal the JAX package's. ``CodecDecoder.random`` draws the
JAX package's shapes from a ``torch.Generator`` and decodes finite audio
of ``output_length`` samples, and the decoder places itself on the device
it is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models.codec.legacy_decoder import CodecDecoder as JDecoder
from qwen3_tts_tpu.models.codec.legacy_decoder import LegacyDecoderConfig as JConfig
from qwen3_tts_tpu_torch.models.codec.legacy_decoder import CodecDecoder, LegacyDecoderConfig
from test_quantizer import _legacy_synthetic_weights

torch.set_num_threads(1)

CONFIGS = {
    "two_stages": dict(hidden_size=32, num_layers=1, num_heads=2, upsample_ratios=(2, 3), num_quantizers=4,
                       codebook_dim=8, codebook_size=16),
    # 128 channels halved four times: 8 at the end. With 3 (hidden 48) the RMS norms over 3 channels amplify f32
    # rounding: the JAX decoder itself lands 1.0e-5 of max|audio| from a float64 run of the same weights there.
    "four_stages": dict(hidden_size=128, num_layers=2, num_heads=4, upsample_ratios=(2, 5, 3, 2), num_quantizers=3,
                        codebook_dim=8, codebook_size=32),
}
FRAMES = (5, 7)
TOL = 1e-5  # of max|audio|: f32 on both sides, sums in other orders


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_weights_matches_jax(name):
    kw = CONFIGS[name]
    jcfg, tcfg = JConfig(**kw), LegacyDecoderConfig(**kw)
    weights = _legacy_synthetic_weights(jcfg, seed=1)
    jdec = JDecoder.from_weights(weights, jcfg)
    tdec = CodecDecoder.from_weights(weights, tcfg, device="cpu")
    rs = np.random.RandomState(4)
    for frames in FRAMES:
        tokens = rs.randint(0, tcfg.codebook_size, (2, tcfg.num_quantizers, frames))
        want = np.asarray(jdec.decode(jnp.asarray(tokens)))
        got = tdec.decode(tokens)
        assert tcfg.output_length(frames) == jcfg.output_length(frames)
        assert got.shape == want.shape == (2, tcfg.output_length(frames))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        scale = np.abs(want).max()
        assert scale > 1e-3
        assert np.abs(got.numpy() - want).max() <= TOL * scale


def test_from_weights_takes_a_prefix():
    kw = CONFIGS["two_stages"]
    weights = _legacy_synthetic_weights(JConfig(**kw), seed=2)
    tokens = np.random.RandomState(5).randint(0, kw["codebook_size"], (1, kw["num_quantizers"], 4))
    plain = CodecDecoder.from_weights(weights, LegacyDecoderConfig(**kw), device="cpu").decode(tokens)
    prefixed = {"decoder." + k: v for k, v in weights.items()}
    got = CodecDecoder.from_weights(prefixed, LegacyDecoderConfig(**kw), prefix="decoder.", device="cpu").decode(tokens)
    assert torch.equal(got, plain)


def test_random_decoder_shapes():
    cfg = LegacyDecoderConfig(**CONFIGS["two_stages"])
    dec = CodecDecoder.random(torch.Generator().manual_seed(3), cfg, device="cpu")
    jdec = JDecoder.random(jax.random.PRNGKey(3), JConfig(**CONFIGS["two_stages"]))
    want = [tuple(v.shape) for v in jax.tree_util.tree_leaves(jdec.params)]
    got = [tuple(v.shape) for v in jax.tree_util.tree_leaves(dec.params)]
    # Conv kernels keep PyTorch's layouts in the port ([Cout, Cin, K]; transposed [Cin, Cout, K]), the JAX
    # package's [K, Cin, Cout] / [K, Cout, Cin]: the same sizes, reversed.
    assert sorted(map(sorted, got)) == sorted(map(sorted, want))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 16, (1, 4, 5)))
    audio = dec.decode(tokens)
    assert audio.shape == (1, cfg.output_length(5))
    assert torch.isfinite(audio).all()


def test_decoder_runs_on_the_card_by_default(monkeypatch):
    """Without ``device`` the decoder goes to the card, and raises where
    there is none (no quiet CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = CONFIGS["two_stages"]
    with pytest.raises(RuntimeError):
        CodecDecoder.random(torch.Generator().manual_seed(0), LegacyDecoderConfig(**kw))
    with pytest.raises(RuntimeError):
        CodecDecoder.from_weights(_legacy_synthetic_weights(JConfig(**kw)), LegacyDecoderConfig(**kw))
