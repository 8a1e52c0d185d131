"""Seeded weights and reference audio for the full-width speaker encoder
(ECAPA at the 1.7B Base checkpoint's enc_dim 2048) and the Mimi encoder
(``MimiEncoderConfig()``), and the x-vectors and codes the JAX package
gives them (a committed fixture).

``tests/test_torch_encoders_full.py`` holds the JAX package's
``SpeakerEncoder.encode`` and ``Encoder12Hz.encode`` (its XLA paths on the
CPU, f32 at HIGHEST precision, mel frames and samples bucketed and masked)
and the port's (at the true length) to the fixture; ``chip_smoke.py`` holds
the port's encoders on the card to it. Both build the same weights here,
from one seed, with numpy's legacy ``RandomState``: uniform values of
standard deviation gain / sqrt(fan-in) for the convolutions and
projections (so the activations keep their scale through both stacks),
norms, layer scales and biases drawn nonzero around their init, and
codebooks of unit scale. The trees have the JAX package's layout, which
``models.weights.speaker_encoder_from_numpy`` and
``mimi_encoder_from_numpy`` take.

The references are 3 s of a seeded signal (a few harmonics of a gliding
pitch, an envelope and noise), one at 24 kHz and one at 16 kHz; the 16 kHz
one goes through ``audio.resample.resample_to_24k`` first, as
``Qwen3TTS.create_voice_clone_prompt`` takes it.

    JAX_PLATFORMS=cpu python tests/test_torch_encoders_full.py   # rewrites the fixture
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .cp_fixture import _uniform
from .models.codec.encoder import MimiEncoderConfig
from .models.config import SpeakerEncoderConfig, config_for_variant

SEED = 2048
SECONDS = 3
RATES = (24000, 16000)
FIXTURE = Path(__file__).resolve().parent / "testdata" / "encoders_1p7b.npz"


def speaker_config() -> SpeakerEncoderConfig:
    """The 1.7B Base checkpoint's speaker encoder (enc_dim = talker hidden 2048)."""
    return config_for_variant("1.7B", "base").speaker_encoder


def mimi_config() -> MimiEncoderConfig:
    return MimiEncoderConfig()


def speaker_numpy_params(cfg: SpeakerEncoderConfig, seed: int = SEED) -> dict:
    """The ECAPA f32 tree (the JAX package's layout: conv kernels [K, Cin, Cout])."""
    rs = np.random.RandomState(seed)

    def dense(cin, cout, gain=1.0):
        return _uniform(rs, (cin, cout), gain / cin**0.5), _uniform(rs, (cout,), 0.02)

    def tdnn(cin, cout, k):
        return {"w": _uniform(rs, (k, cin, cout), 1 / (k * cin) ** 0.5), "b": _uniform(rs, (cout,), 0.02)}

    ch, ks, se = cfg.enc_channels, cfg.enc_kernel_sizes, cfg.enc_se_channels
    chunk = ch[1] // cfg.enc_res2net_scale
    blocks = []
    for i in range(1, 4):
        c1w, c1b = dense(ch[i], se)
        c2w, c2b = dense(se, ch[i])
        blocks.append({
            "tdnn1": tdnn(ch[i], ch[i], 1),
            "res2net": [tdnn(chunk, chunk, ks[i]) for _ in range(cfg.enc_res2net_scale - 1)],
            "tdnn2": tdnn(ch[i], ch[i], 1),
            "se": {"conv1_w": c1w, "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b},
        })
    asp_w, asp_b = dense(cfg.enc_attention_channels, ch[4])
    fc_w, fc_b = dense(ch[4] * 2, cfg.enc_dim)
    return {
        "initial": tdnn(cfg.mel_dim, ch[0], ks[0]),
        "se_res2net": blocks,
        "mfa": tdnn(sum(ch[1:4]), ch[4], ks[4]),
        "asp": {"tdnn": tdnn(ch[4] * 3, cfg.enc_attention_channels, 1), "conv_w": asp_w, "conv_b": asp_b},
        "fc_w": fc_w,
        "fc_b": fc_b,
    }


def mimi_numpy_params(cfg: MimiEncoderConfig, seed: int = SEED) -> dict:
    """The Mimi encoder's f32 tree (the JAX package's layout, as
    ``init_encoder_params`` builds it)."""
    rs = np.random.RandomState(seed + 1)

    def w(shape, fan_in, gain=1.0):
        return _uniform(rs, shape, gain / fan_in**0.5)

    def near(n, v, spread):
        return np.float32(v) + _uniform(rs, (n,), spread)

    def conv(cin, cout, k, gain=1.0):
        return w((k, cin, cout), k * cin, gain), near(cout, 0.0, 0.02)

    ch, stages = cfg.num_filters, []
    for r in reversed(cfg.ratios):
        c1w, c1b = conv(ch, ch // cfg.compress, cfg.residual_kernel_size)
        c2w, c2b = conv(ch // cfg.compress, ch, 1, 0.5)
        dw, db = conv(ch, ch * 2, 2 * r)
        stages.append({"resnet": {"conv1_w": c1w, "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b},
                       "down_w": dw, "down_b": db, "ratio": r})
        ch *= 2
    hs, hd, inter = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.intermediate_size
    layers = [{
        "ln1_w": near(hs, 1.0, 0.1), "ln1_b": near(hs, 0.0, 0.02),
        "q_proj": w((hs, hd), hs), "k_proj": w((hs, hd), hs), "v_proj": w((hs, hd), hs), "o_proj": w((hd, hs), hd),
        "attn_scale": near(hs, 0.1, 0.02),
        "ln2_w": near(hs, 1.0, 0.1), "ln2_b": near(hs, 0.0, 0.02),
        "fc1": w((hs, inter), hs), "fc2": w((inter, hs), inter),
        "mlp_scale": near(hs, 0.1, 0.02),
    } for _ in range(cfg.num_layers)]
    init_w, init_b = conv(1, cfg.num_filters, cfg.kernel_size)
    final_w, final_b = conv(ch, hs, cfg.last_kernel_size)
    return {
        "seanet": {"init_w": init_w, "init_b": init_b, "stages": stages, "final_w": final_w, "final_b": final_b},
        "transformer": {"layers": layers},
        "downsample_w": w((2 * cfg.downsample_stride, hs, hs), 2 * cfg.downsample_stride * hs),
        "semantic_proj": w((hs, cfg.codebook_dim), hs),
        "semantic_codebooks": _uniform(rs, (1, cfg.codebook_size, cfg.codebook_dim), 1.0),
        "acoustic_proj": w((hs, cfg.codebook_dim), hs),
        "acoustic_codebooks": _uniform(rs, (cfg.num_quantizers - 1, cfg.codebook_size, cfg.codebook_dim), 1.0),
    }


def reference_audio(rate: int, seed: int = SEED, seconds: float = SECONDS) -> np.ndarray:
    """``seconds`` of a seeded voice-like signal at ``rate`` Hz, f32 in [-1, 1]."""
    rs = np.random.RandomState(seed + rate)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = 110 + 60 * np.sin(2 * np.pi * 0.7 * t + rs.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voice = sum(rs.uniform(0.2, 1.0) / h * np.sin(h * phase) for h in range(1, 9))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 2.3 * t) ** 2
    signal = 0.25 * envelope * voice + 0.02 * rs.standard_normal(n)
    return signal.astype(np.float32)


def load() -> dict:
    """The fixture: for each of ``RATES``, ``xvector_<rate>`` [enc_dim] f32,
    ``codes_<rate>`` [T, 16] int32 and ``margin_<rate>`` [T, 16] (each
    code's squared-distance gap to the runner-up codeword, by the JAX
    package's f32 encoder)."""
    with np.load(FIXTURE) as f:
        return dict(f)
